// EmbeddingBag(sum) for Hopper (sm_90a): out[b] = sum over the entries e of
// bag b of w[e] * table[idx[e]], float32; an entry with idx < 0 is padding
// and adds nothing, a bag without entries is zero.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py embedding_bag: a
// scalar-prefetch grid of one table row per step, whose output block stays
// resident while consecutive steps hit the same (sorted) bag.
//
// What bounds it on an H100. Two operations per gathered float against four
// bytes read: device memory, and a gather at that, of the rows the bags name
// (512 floats = 2 KiB each at the paper's width) plus the output.
//
// What the design does about it. One warp per bag. The bag's entries are
// the run [offsets[b], offsets[b + 1]) of the sorted bag ids (the wrapper
// computes the offsets with searchsorted). Each lane owns 16-byte float4
// columns of the row, so a warp reads 512 contiguous bytes per load; the
// entries are summed in index order with separately rounded products and
// sums, as the plain version's weighted rows and index_add_ do. Padding is
// skipped, never read, so padded entries and empty bags give exact zeros.
// Rows whose width is not a multiple of four, or a table not 16-byte
// aligned, take the one-float path.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // bags per block

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx,
                     const int* __restrict__ offsets,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int num_bags, int dim) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= num_bags) return;
  const int beg = offsets[bag];
  const int end = offsets[bag + 1];
  float* o = out + static_cast<long long>(bag) * dim;
  for (int col = lane * kVec; col < dim; col += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = 0.f;
    for (int e = beg; e < end; ++e) {
      const int i = idx[e];
      if (i < 0) continue;
      const float w = weights ? weights[e] : 1.f;
      const float* row = table + static_cast<long long>(i) * dim + col;
      float x[kVec];
      if constexpr (kVec == 4) {
        const float4 q = *reinterpret_cast<const float4*>(row);
        x[0] = q.x;
        x[1] = q.y;
        x[2] = q.z;
        x[3] = q.w;
      } else {
        x[0] = row[0];
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(w, x[v]));
    }
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(o + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      o[col] = acc[0];
    }
  }
}

}  // namespace

// table: (V, dim) float32; idx: (L,) int32, -1 = padding; offsets:
// (num_bags + 1,) int32, the start of each bag in idx; weights: (L,)
// float32 or null; out: (num_bags, dim) float32; all on the card. vec4 = 1
// when dim % 4 == 0 and table and out are 16-byte aligned. Returns a
// cudaError_t.
extern "C" int repro_embedding_bag(const void* table, const void* idx,
                                   const void* offsets, const void* weights,
                                   void* out, int num_bags, int dim, int vec4,
                                   void* stream) {
  const unsigned blocks = static_cast<unsigned>((num_bags + kWarps - 1) / kWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(idx);
  const auto* off = static_cast<const int*>(offsets);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  if (vec4) {
    embedding_bag_kernel<4><<<blocks, kWarps * 32, 0, st>>>(t, i, off, w, o, num_bags, dim);
  } else {
    embedding_bag_kernel<1><<<blocks, kWarps * 32, 0, st>>>(t, i, off, w, o, num_bags, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
