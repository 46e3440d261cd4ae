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
// held in VMEM. Here a block owns a tile of `tile` queries, a group of
// `group` code columns and a span of `kc` codewords; ops.fused_lut_plan
// picks the three: one block for 128 of the SMs, with the fewest L2 reads
// (each block reads its query tile, the group's qdelta slab and its
// codewords through L2, which the table's writes cross too). Two stages:
//   1. rotate: 16-byte cp.async copies stage the query tile (rows padded
//      by 4 floats, so the rows a warp reads at one input fall in distinct
//      banks) and the group's qdelta column slab (n x group*sub) in shared
//      memory, once per block, so Q crosses L2 once per column group and
//      not once per column. The n inputs are cut into `runs` runs of
//      ceil(n / runs) inputs, and `runs` is a function of n alone
//      (ops.fused_lut_plan): each thread forms a register tile of rq
//      queries x 4 slab columns over a run (float32 FMAs; a float4 slab
//      read serves 4 x rq of them), stores the run's partial sums apart
//      and goes on to its next run while the block has fewer threads
//      than register tiles x runs; the runs' partial sums are then added
//      in run order. So every entry's sums run in one order whatever the
//      batch, the tile, rq, the group or the span: a query's table is
//      bit-equal in any batch. The plan picks rq so that the register
//      tiles keep every thread busy where they can.
//   2. write: each thread holds four consecutive codewords of one column
//      in registers (prefetched into L1 while stage 1 runs) and, for every
//      query of the tile, writes their four table entries as one 16-byte
//      store, so a warp writes 512 contiguous bytes of lut[b, p, :] at a
//      time; the stores are posted, so one query's writes drain while the
//      next query's FMAs run. K not a multiple of 4 takes scalar stores
//      (the table's rows are then not 16-byte aligned), and a group or a
//      span that runs past Dp or K is cut inside the kernel.
// The two stages do not overlap on an SM: a block's writes start when its
// rotation ends, and splitting the block into rotating and writing warps
// over sub-tiles, or writing through bulk copies, measured slower on an
// H100 (PERF.md). No TF32: plain float32 FMAs; the sums run in another
// order than the plain version's matmul.
// SUB (the subspace width) is a template parameter: 4, 8 or 16, and so is
// RQ, the queries of a thread's register tile: 1, 2, 4 or 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

template <int SUB, int RQ>
__global__ void __launch_bounds__(kThreads)
fused_lut_kernel(const float* __restrict__ Q, const float* __restrict__ qdelta,
                 const float* __restrict__ cb, const int* __restrict__ cmap,
                 float* __restrict__ lut, int b, int n, int Dp, int K,
                 int tile, int group, int kc, int ksplit, int runs,
                 bool vec_in, bool vec_out) {
  static_assert(SUB % 4 == 0, "float4 reads of the slab");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = n + 4;                 // padded query row
  const int gs = group * SUB;            // slab columns
  const int gs4 = gs / 4;
  const int tq = tile / RQ;              // query rows of a register tile
  const int t1 = tq * gs4;               // register tiles, a power of two
  float* qd_s = smem;                    // n x gs qdelta slab
  float* q_s = qd_s + n * gs;            // tile x ldq queries
  float* part = q_s + tile * ldq;        // runs x tile x gs partial sums,
                                         // run 0's slots then the tile x gs
                                         // rotated sub-queries

  int blk = blockIdx.x;
  const int k0 = (blk % ksplit) * kc;
  blk /= ksplit;
  const int groups = (Dp + group - 1) / group;
  const int p0 = (blk % groups) * group;
  const int b0 = (blk / groups) * tile;
  const int rows = min(tile, b - b0);
  const int k1 = min(K, k0 + kc);
  const int tid = threadIdx.x;

  // the query tile (rows past b as zeros) and the column slab
  if (vec_in) {
    const int n4 = n / 4;
    for (int e = tid; e < tile * n4; e += kThreads) {
      const int r = e / n4;
      const int v = 4 * (e - r * n4);
      const bool ok = r < rows;
      repro::cp_async16(q_s + r * ldq + v,
                        ok ? Q + static_cast<long long>(b0 + r) * n + v : Q,
                        ok);
    }
    constexpr int kSub4 = SUB / 4;
    for (int e = tid; e < n * gs4; e += kThreads) {
      const int c = e / gs4;
      const int f = e - c * gs4;
      const int g = f / kSub4;
      const int p = min(p0 + g, Dp - 1);
      repro::cp_async16(qd_s + c * gs + 4 * f,
                        qdelta + static_cast<long long>(c) * n +
                            __ldg(cmap + p) * SUB + 4 * (f - g * kSub4),
                        true);
    }
  } else {
    for (int e = tid; e < tile * n; e += kThreads) {
      const int r = e / n;
      const int v = e - r * n;
      const bool ok = r < rows;
      repro::cp_async4(q_s + r * ldq + v,
                       ok ? Q + static_cast<long long>(b0 + r) * n + v : Q,
                       ok);
    }
    for (int e = tid; e < n * gs; e += kThreads) {
      const int c = e / gs;
      const int f = e - c * gs;
      const int g = f / SUB;
      const int p = min(p0 + g, Dp - 1);
      repro::cp_async4(qd_s + c * gs + f,
                       qdelta + static_cast<long long>(c) * n +
                           __ldg(cmap + p) * SUB + (f - g * SUB),
                       true);
    }
  }
  repro::cp_async_commit();

  // the write stage's mapping: item = (column g of the group, four
  // codewords); while there are fewer items than threads, qs threads share
  // an item, each taking every qs-th query of the tile
  const int kc4 = (k1 - k0 + 3) / 4;
  const int items = group * kc4;
  const int qs = max(1, kThreads / items);
  if (tid < items * qs) {   // the first item's codewords, into L1
    const int item = tid % items;
    const int g = item / kc4;
    const int k = k0 + 4 * (item - g * kc4);
    if (p0 + g < Dp) {
      const float* src = cb + (static_cast<long long>(p0 + g) * K + k) * SUB;
      for (int kk = 0; kk < 4 && k + kk < k1; kk += (32 + SUB - 1) / SUB)
        prefetch_l1(src + kk * SUB);
    }
  }

  // rotate: register tile of RQ queries qg, qg + tq, ... x 4 slab columns
  // over the inputs [lo, hi) of each run this thread walks
  repro::cp_async_wait<0>();
  __syncthreads();
  {
    const int u = tid % t1;
    const int lanes = kThreads / t1;   // threads past lanes x t1 idle
    const int qg = u / gs4;
    const int cg = u - qg * gs4;
    const int len = (n + runs - 1) / runs;
    const float* qrow = q_s + qg * ldq;
    const float4* w4 = reinterpret_cast<const float4*>(qd_s) + cg;
    for (int run = tid / t1; run < runs && tid < lanes * t1; run += lanes) {
      const int lo = min(n, run * len);
      const int hi = min(n, lo + len);
      float acc[RQ][4];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 4
      for (int c = lo; c < hi; ++c) {
        const float4 w = w4[c * gs4];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float x = qrow[r * tq * ldq + c];
          acc[r][0] = __fmaf_rn(x, w.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(x, w.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(x, w.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(x, w.w, acc[r][3]);
        }
      }
      float* out = part + run * tile * gs;
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        reinterpret_cast<float4*>(out + (qg + r * tq) * gs)[cg] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  // the runs' partial sums, added in run order into run 0's slots
  for (int o = tid; o < tile * gs; o += kThreads) {
    float sum = part[o];
#pragma unroll 4
    for (int r = 1; r < runs; ++r)
      sum = __fadd_rn(sum, part[r * tile * gs + o]);
    part[o] = sum;
  }
  __syncthreads();

  // write: four codewords of one column against every query of the tile
  for (int e = tid; e < items * qs; e += kThreads) {
    const int item = e % items;
    const int i0 = e / items;
    const int g = item / kc4;
    const int p = p0 + g;
    if (p >= Dp) continue;
    const int k = k0 + 4 * (item - g * kc4);
    float w[4][SUB];
    const float* src = cb + (static_cast<long long>(p) * K + k) * SUB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bool ok = k + kk < k1;
#pragma unroll
      for (int v = 0; v < SUB / 4; ++v) {
        const float4 w4 =
            ok ? __ldg(reinterpret_cast<const float4*>(src + kk * SUB) + v)
               : make_float4(0.f, 0.f, 0.f, 0.f);
        w[kk][4 * v] = w4.x;
        w[kk][4 * v + 1] = w4.y;
        w[kk][4 * v + 2] = w4.z;
        w[kk][4 * v + 3] = w4.w;
      }
    }
    float* out = lut + (static_cast<long long>(b0 + i0) * Dp + p) * K + k;
    const long long stride = static_cast<long long>(qs) * Dp * K;
    for (int i = i0; i < rows; i += qs, out += stride) {
      const float4* x4 =
          reinterpret_cast<const float4*>(part + i * gs + g * SUB);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < SUB / 4; ++v) {
        const float4 x = x4[v];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          a[kk] = __fmaf_rn(x.x, w[kk][4 * v], a[kk]);
          a[kk] = __fmaf_rn(x.y, w[kk][4 * v + 1], a[kk]);
          a[kk] = __fmaf_rn(x.z, w[kk][4 * v + 2], a[kk]);
          a[kk] = __fmaf_rn(x.w, w[kk][4 * v + 3], a[kk]);
        }
      }
      if (vec_out) {
        *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (k + kk < k1) out[kk] = a[kk];
      }
    }
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Shared memory of one block, in bytes, as ops.fused_lut_plan counts it:
// the slab, the padded query tile and the runs' partial sums.
long long smem_bytes(int n, int sub, int tile, int group, int runs) {
  const long long gs = static_cast<long long>(group) * sub;
  const long long q = static_cast<long long>(tile) * (n + 4);
  const long long part = static_cast<long long>(runs) * tile * gs;
  return 4 * (n * gs + q + part);
}

// A block's share of the table (ops.fused_lut_plan): tile queries, group
// code columns, kc codewords; its rotation's register tiles of rq queries
// and runs of the inputs.
struct Layout {
  int tile, group, kc, rq, runs;
};

template <int SUB, int RQ>
cudaError_t launch(const void* Q, const void* qdelta, const void* cb,
                   const void* cmap, void* lut, int b, int n, int Dp, int K,
                   Layout lay, long long smem, cudaStream_t stream) {
  auto kernel = fused_lut_kernel<SUB, RQ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int ksplit = (K + lay.kc - 1) / lay.kc;
  const long long blocks = static_cast<long long>((b + lay.tile - 1) /
                                                  lay.tile) *
                           ((Dp + lay.group - 1) / lay.group) * ksplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec_in = reinterpret_cast<uintptr_t>(Q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(qdelta) % 16 == 0;
  const bool vec_out =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(lut) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kThreads,
           static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(Q), static_cast<const float*>(qdelta),
      static_cast<const float*>(cb), static_cast<const int*>(cmap),
      static_cast<float*>(lut), b, n, Dp, K, lay.tile, lay.group, lay.kc,
      ksplit, lay.runs, vec_in, vec_out);
  return cudaGetLastError();
}

template <int SUB>
cudaError_t launch_sub(const void* Q, const void* qdelta, const void* cb,
                       const void* cmap, void* lut, int b, int n, int Dp,
                       int K, Layout lay, long long smem, cudaStream_t st) {
  switch (lay.rq) {
    case 1:
      return launch<SUB, 1>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                            st);
    case 2:
      return launch<SUB, 2>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                            st);
    case 4:
      return launch<SUB, 4>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                            st);
    default:
      return launch<SUB, 8>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                            st);
  }
}

}  // namespace

// Q (b, n), qdelta (n, n), cb (Dp, K, sub), lut (b, Dp, K): row-major
// float32, cb 16-byte aligned; cmap (Dp,) int32 with entries in
// [0, n / sub); sub in {4, 8, 16}; tile a power of two up to 32; group a
// power of two; kc a multiple of 4; rq in {1, 2, 4, 8} dividing tile, with
// (tile / rq) * group * sub / 4 register tiles at most 256 threads; runs
// the plan's runs of the inputs (a function of n); smem the plan's shared
// memory, which must equal this file's count. Returns a cudaError_t.
extern "C" int repro_fused_lut(const void* Q, const void* qdelta,
                               const void* cb, const void* cmap, void* lut,
                               int b, int n, int Dp, int K, int sub, int tile,
                               int group, int kc, int rq, int runs,
                               long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pow2(tile) || tile > 32 || !pow2(group) || kc < 4 || kc % 4 ||
      n % 4 || (sub != 4 && sub != 8 && sub != 16) || !pow2(rq) || rq > 8 ||
      tile % rq || runs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((tile / rq) * group * sub / 4 > kThreads ||
      smem != smem_bytes(n, sub, tile, group, runs))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{tile, group, kc, rq, runs};
  switch (sub) {
    case 4:
      return launch_sub<4>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                           st);
    case 8:
      return launch_sub<8>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                           st);
    default:
      return launch_sub<16>(Q, qdelta, cb, cmap, lut, b, n, Dp, K, lay, smem,
                            st);
  }
}
