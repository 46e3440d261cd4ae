// Rotation-fused ADC table build for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/lut_build.py fused_lut:
//   lut[b, p, k] = < (Q . qdelta)[b, subspace map[p]], cb_flat[p, k] >
// Q (b, n) are the queries rotated by the frozen index rotation, qdelta
// (n, n) the query-side transform that fused refresh accumulates, cb_flat
// (Dp, K, sub) the frozen codebooks flattened by code column, and map (Dp,)
// the code column -> query subspace map (identity for PQ; column l*D + d of
// a level-major depth-M RQ reads subspace d).
//
// What bounds it on an H100: bytes. At the serving width (n = 256, Dp = 32,
// K = 256, sub = 8) a 512-query batch reads 1 MB of operands and writes a
// 16.8 MB table: 5.3 us at 3.35 TB/s, against 2.0 us for its 134 MFLOP at
// the float32 rate.
//
// What the design does about it. The TPU kernel rotates a query block on
// the MXU, expands it to code columns by a one-hot matmul with the column
// map (the MXU cannot gather) and contracts it with the whole codebook
// held in VMEM. Here one block owns one tile of queries (32 from the
// wrapper) and one code column p, so the map is one integer read,
// d = map[p]. The block stages the qdelta column slab
// qdelta[:, d*SUB:(d+1)*SUB] in shared memory and forms the tile's rotated
// sub-queries with float32 FMAs: each thread takes one query row and one
// of kThreads / tile contiguous runs of the n inputs, reads its run of the
// row straight from global memory (L2 after the first column's block) as
// float4s, keeps SUB running sums in registers and reads each slab row as
// float4s that the whole warp shares; the runs' partial sums are then
// added in order. Last, each thread holds one codeword of column p in
// registers and writes lut[b, p, k] for every row of the tile, one
// codeword per thread, so a warp's stores are contiguous. Shared memory
// stays near 17 KiB at n = 256, so eight blocks fit on an SM. The first
// version (one output per thread, the query tile and every operand in
// shared memory, two shared-memory loads per FMA) was bound by those loads
// and took more than twice as long (PERF.md). No TF32: the plain
// version's matmul differs only by float32 rounding order. SUB (the
// subspace width) is a template parameter: 4, 8 or 16.
// Later work: several columns per block to reuse a query run, vector
// stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int SUB>
__global__ void __launch_bounds__(kThreads)
fused_lut_kernel(const float* __restrict__ Q, const float* __restrict__ qdelta,
                 const float* __restrict__ cb, const int* __restrict__ cmap,
                 float* __restrict__ lut, int b, int n, int Dp, int K,
                 int tile, bool vec4) {
  static_assert(SUB % 4 == 0, "float4 reads of the slab");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int parts = blockDim.x / tile;
  float* qd_s = smem;                    // n x SUB slab of qdelta
  float* qr_s = qd_s + n * SUB;          // tile x SUB rotated sub-queries
  float* part_s = qr_s + tile * SUB;     // parts x tile x SUB partial sums
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int rows = min(tile, b - b0);
  const int c0 = cmap[p] * SUB;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * SUB; e += blockDim.x) {
    const int c = e / SUB;
    qd_s[e] = qdelta[static_cast<long long>(c) * n + c0 + (e - c * SUB)];
  }
  __syncthreads();

  // partial rotated sub-query of row i over the inputs [lo, hi); a warp
  // holds 32 rows at the same inputs, so the slab reads are broadcasts
  {
    const int i = tid % tile;
    const int part = tid / tile;
    const int chunk = (n + parts - 1) / parts;
    const int lo = min(n, part * chunk);
    const int hi = min(n, lo + chunk);
    float acc[SUB];
#pragma unroll
    for (int j = 0; j < SUB; ++j) acc[j] = 0.f;
    if (i < rows) {
      const float* qrow = Q + static_cast<long long>(b0 + i) * n;
      auto step = [&](int c, float x) {
        const float4* w = reinterpret_cast<const float4*>(qd_s + c * SUB);
#pragma unroll
        for (int v = 0; v < SUB / 4; ++v) {
          const float4 w4 = w[v];
          acc[4 * v] = __fmaf_rn(x, w4.x, acc[4 * v]);
          acc[4 * v + 1] = __fmaf_rn(x, w4.y, acc[4 * v + 1]);
          acc[4 * v + 2] = __fmaf_rn(x, w4.z, acc[4 * v + 2]);
          acc[4 * v + 3] = __fmaf_rn(x, w4.w, acc[4 * v + 3]);
        }
      };
      if (vec4) {   // lo and hi are multiples of 4, the row 16-byte aligned
        for (int c = lo; c < hi; c += 4) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(qrow + c));
          step(c, x4.x);
          step(c + 1, x4.y);
          step(c + 2, x4.z);
          step(c + 3, x4.w);
        }
      } else {
        for (int c = lo; c < hi; ++c) step(c, __ldg(qrow + c));
      }
    }
    if (part < parts) {
#pragma unroll
      for (int j = 0; j < SUB; ++j)
        part_s[(part * tile + i) * SUB + j] = acc[j];
    }
  }
  __syncthreads();
  for (int o = tid; o < tile * SUB; o += blockDim.x) {
    float sum = 0.f;
    for (int part = 0; part < parts; ++part)
      sum = __fadd_rn(sum, part_s[part * tile * SUB + o]);
    qr_s[o] = sum;
  }
  __syncthreads();

  const float* cbp = cb + static_cast<long long>(p) * K * SUB;
  for (int k = tid; k < K; k += blockDim.x) {
    float w[SUB];
    const float4* src = reinterpret_cast<const float4*>(cbp + k * SUB);
#pragma unroll
    for (int v = 0; v < SUB / 4; ++v) {
      const float4 w4 = src[v];
      w[4 * v] = w4.x;
      w[4 * v + 1] = w4.y;
      w[4 * v + 2] = w4.z;
      w[4 * v + 3] = w4.w;
    }
    float* out = lut + (static_cast<long long>(b0) * Dp + p) * K + k;
    for (int i = 0; i < rows; ++i) {
      const float4* qr = reinterpret_cast<const float4*>(qr_s + i * SUB);
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < SUB / 4; ++v) {
        const float4 q4 = qr[v];
        acc = __fmaf_rn(q4.x, w[4 * v], acc);
        acc = __fmaf_rn(q4.y, w[4 * v + 1], acc);
        acc = __fmaf_rn(q4.z, w[4 * v + 2], acc);
        acc = __fmaf_rn(q4.w, w[4 * v + 3], acc);
      }
      out[static_cast<long long>(i) * Dp * K] = acc;
    }
  }
}

// Shared memory of one block, in bytes (ops.fused_lut checks the same
// sum against the card's limit before it launches).
long long smem_bytes(int n, int sub, int tile) {
  const long long parts = kThreads / tile;
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(n) * sub + (1 + parts) * tile * sub);
}

template <int SUB>
cudaError_t launch(const void* Q, const void* qdelta, const void* cb,
                   const void* cmap, void* lut, int b, int n, int Dp, int K,
                   int tile, cudaStream_t stream) {
  const long long smem = smem_bytes(n, SUB, tile);
  auto kernel = fused_lut_kernel<SUB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int parts = kThreads / tile;
  const bool vec4 = n % (4 * parts) == 0 &&
                    reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((b + tile - 1) / tile),
                  static_cast<unsigned>(Dp));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(Q), static_cast<const float*>(qdelta),
      static_cast<const float*>(cb), static_cast<const int*>(cmap),
      static_cast<float*>(lut), b, n, Dp, K, tile, vec4);
  return cudaGetLastError();
}

}  // namespace

// Q (b, n), qdelta (n, n), cb (Dp, K, sub), lut (b, Dp, K): row-major
// float32, cb 16-byte aligned; cmap (Dp,) int32 with entries in
// [0, n / sub); sub in {4, 8, 16}; tile divides kThreads. Returns a
// cudaError_t.
extern "C" int repro_fused_lut(const void* Q, const void* qdelta,
                               const void* cb, const void* cmap, void* lut,
                               int b, int n, int Dp, int K, int sub, int tile,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sub) {
    case 4: return launch<4>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, tile, st);
    case 8: return launch<8>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, tile, st);
    case 16:
      return launch<16>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
