// Product-quantizer assignment for Hopper (sm_90a): for each row x and
// subspace d, the argmin over k of ||C[d,k]||^2 - 2 <x_d, C[d,k]>, float32,
// ties to the lowest k.
//
// Replaces the TPU kernel repro/kernels/pq_assign.py pq_assign, which fuses
// the distance product on the MXU with the argmin so the (rows, K) score
// tile never leaves VMEM, and keeps subspace d's whole (K, sub) codebook in
// VMEM for a block of 512 rows.
//
// What bounds it on an H100. 2 m n K operations against 4 m n bytes of X:
// K/2 operations per byte read, 128 at K = 256, so the float32 rate bounds
// it. Tensor cores are ruled out on purpose: TF32 keeps ten mantissa bits
// and would move near-equal scores past each other, flipping codes. A score
// also costs more than its FMAs: at sub = 8 about 12 instruction slots (8
// FMAs, the score, a compare, two selects) for 8 counted FMAs, so the
// ceiling is about two thirds of the float32 rate.
//
// What the design does about it. One entry point, two bodies; the wrapper's
// launch plan (ops.pq_assign_plan) picks the body, the threads and the rows
// per block from the shape, and states the shared memory, which the entry
// holds to the layout's own (smem_bytes) before it launches.
//  * Resident codebook (sub <= 16: every PQ shape of the main path, K = 256,
//    sub = 8). A block is a run of rows of one subspace d. It copies
//    codebook d into shared memory once (12 KiB at K = 256 with rows padded
//    against bank conflicts, 16-byte loads), sums each codeword's norm once
//    (one thread per codeword, ascending FMAs), and each thread keeps RPT
//    rows' subvectors in registers (8 at large m; float4 loads, 32 bytes a
//    row at sub = 8), so a codeword read from shared memory serves 8 rows.
//    The thread walks its codewords in ascending k, reading each by
//    broadcast (the lanes that share a row group read the same address),
//    does sub FMAs a row and keeps a running (best, k) a row with a strict
//    <, so ties go to the lowest k with no exchange. For few rows (a decode
//    step's 16) the plan gives each row `split` lanes that take every
//    split-th codeword and reduce their candidates by (score, k).
//  * Register-tiled product (sub > 16, or a codebook too large for shared
//    memory: the coarse quantizer, K = 1024, sub = 256). A block of 256
//    threads keeps 16 x RM rows of X in shared memory (read from device
//    memory once) and walks the codebook in tiles of 128 codewords, each in
//    slabs of 32 columns double-buffered with cp.async; each thread holds
//    RM x 8 dot products in registers (rows ty + 16 i, codewords
//    tx + 16 j), reading float4 runs of both. Two threads a codeword sum its
//    norm, in parts, while its slab is in shared memory, once per block.
//    After each tile a thread folds its scores into a running (best, k) per
//    row in ascending k; the 16 threads sharing a row reduce by (score, k).
//    A subvector too wide for even 16 rows of it in shared memory (more
//    than about 3,000 floats) takes the same body with X streamed: the
//    rows' 32-column slab rides in the ring beside the codewords' and is
//    read again for every codeword tile.
// Dot products are summed over the subvector in ascending order with plain
// FMAs in both bodies. Ragged m, K and sub are masked; a subvector whose
// width is not a multiple of 4 is zero-padded to one (zero terms change no
// sum).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxThreads = 256;
// tiled body
constexpr int kTileCodes = 128;               // codewords per tile
constexpr int kTileSlab = 32;                 // subvector columns per slab
constexpr int kLdc = kTileSlab + 4;           // padded slab row
constexpr int kCodesPerThread = kTileCodes / 16;
constexpr int kNormParts = kMaxThreads / kTileCodes;  // threads per norm
static_assert(kTileSlab % (4 * kNormParts) == 0,
              "the norm parts split a slab into float4 runs");

template <int W>
__device__ __forceinline__ void load4s(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

// Shared-memory row of a codeword of SP floats in the resident body: an odd
// number of 16-byte runs, so the 8 lanes of a quarter warp that read 8
// consecutive codewords (the split scan, the norms) hit 8 distinct groups of
// banks.
__host__ __device__ constexpr int resident_ld(int sp) {
  return (sp / 4) % 2 ? sp : sp + 4;
}

// (best, k) of b replaced by (ob, ok) if that is smaller, ties to lower k
__device__ __forceinline__ void take_min(float& b, int& k, float ob, int ok) {
  if (ob < b || (ob == b && ok < k)) {
    b = ob;
    k = ok;
  }
}

// -- resident codebook -------------------------------------------------------

// SP: sub rounded up to a multiple of 4 (4, 8, 12 or 16); RPT: rows a thread
// keeps in registers. Block: blockDim.x threads in row groups of `split`
// lanes; grid: D x row blocks, flattened with d fastest so the blocks in
// flight read whole rows of X between them.
template <int SP, int RPT>
__global__ void __launch_bounds__(kMaxThreads)
pq_resident_kernel(const float* __restrict__ X, const float* __restrict__ C,
                   int* __restrict__ codes, long long m, int n, int D, int K,
                   int sub, int split, bool vec) {
  constexpr int LD = resident_ld(SP);
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // K x LD, zero-padded
  float* cn = cs + K * LD;                      // K norms
  const int d = static_cast<int>(blockIdx.x % D);
  const long long rb = static_cast<long long>(blockIdx.x / D);
  const int groups = blockDim.x / split;
  const int g = threadIdx.x / split;
  const int lane = threadIdx.x - g * split;
  const long long row0 = rb * groups * RPT;
  const long long xcol = static_cast<long long>(d) * sub;

  // the rows first, so their loads are in flight while the codebook lands
  float x[RPT][SP];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long row = row0 + g + static_cast<long long>(groups) * r;
    const float* xr = X + row * n + xcol;
    if (row < m && vec) {
      load4s<SP>(xr, x[r]);
    } else {
#pragma unroll
      for (int t = 0; t < SP; ++t) {
        x[r][t] = (row < m && t < sub) ? xr[t] : 0.f;
      }
    }
  }
  const float* Cd = C + static_cast<long long>(d) * K * sub;
  if (vec) {   // sub == SP and 16-byte aligned rows
    const float4* src = reinterpret_cast<const float4*>(Cd);
    for (int e = threadIdx.x; e < K * (SP / 4); e += blockDim.x) {
      const int k = e / (SP / 4);
      *reinterpret_cast<float4*>(cs + k * LD + 4 * (e - k * (SP / 4))) =
          src[e];
    }
  } else {
    for (int e = threadIdx.x; e < K * SP; e += blockDim.x) {
      const int k = e / SP;
      const int t = e - k * SP;
      cs[k * LD + t] = t < sub ? Cd[static_cast<long long>(k) * sub + t] : 0.f;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float c[SP];
    load4s<SP>(cs + k * LD, c);
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < SP; ++t) s = __fmaf_rn(c[t], c[t], s);
    cn[k] = s;
  }
  __syncthreads();

  float best[RPT];
  int arg[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    best[r] = CUDART_INF_F;
    arg[r] = lane;   // this lane's first k: all-inf rows end at k = 0
  }
#pragma unroll 4
  for (int k = lane; k < K; k += split) {   // ascending k, 4 a step
    float c[SP];
    load4s<SP>(cs + k * LD, c);
    const float nk = cn[k];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < SP; ++t) dot = __fmaf_rn(x[r][t], c[t], dot);
      const float s = __fmaf_rn(-2.f, dot, nk);   // = fl(nk - 2 dot)
      if (s < best[r]) {
        best[r] = s;
        arg[r] = k;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    for (int off = split >> 1; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[r], off);
      take_min(best[r], arg[r], ob, oa);
    }
    const long long row = row0 + g + static_cast<long long>(groups) * r;
    if (lane == 0 && row < m) codes[row * D + d] = arg[r];
  }
}

// -- register-tiled product --------------------------------------------------

// RM: rows per thread; a block owns 16 * RM rows of one subspace. XS: the
// rows are streamed a slab at a time beside the codewords (2 x kRows x kLdc)
// instead of kept whole (kRows x (sp + 4)).
template <int RM, bool XS>
__global__ void __launch_bounds__(kMaxThreads)
pq_tiled_kernel(const float* __restrict__ X, const float* __restrict__ C,
                int* __restrict__ codes, long long m, int n, int D, int K,
                int sub, int sp, bool vec) {
  constexpr int CW = kCodesPerThread;
  constexpr int kRows = 16 * RM;
  extern __shared__ float4 smem4[];
  const int ldx = XS ? kLdc : sp + 4;
  // the rows, two codeword slabs of kTileCodes x kLdc, kMaxThreads norm parts
  float* xs = reinterpret_cast<float*>(smem4);
  float* cs = xs + (XS ? 2 * kRows * kLdc : kRows * ldx);
  float* np = cs + 2 * kTileCodes * kLdc;
  const int tid = threadIdx.x;
  const int tx = tid & 15;    // codewords tx + 16 j of each tile
  const int ty = tid >> 4;    // rows ty + 16 i of the block
  const int d = static_cast<int>(blockIdx.x % D);
  const long long row0 = static_cast<long long>(blockIdx.x / D) * kRows;
  const long long xcol = static_cast<long long>(d) * sub;
  const float* Cd = C + static_cast<long long>(d) * K * sub;

  // the row tile, once (the first copy group)
  if constexpr (!XS) {
    if (vec) {
      const int runs = sp / 4;
      for (int e = tid; e < kRows * runs; e += kMaxThreads) {
        const int r = e / runs;
        const int c = (e - r * runs) * 4;
        const long long row = row0 + r;
        const bool ok = row < m;
        repro::cp_async16(xs + r * ldx + c, ok ? X + row * n + xcol + c : X,
                          ok);
      }
    } else {
      for (int e = tid; e < kRows * sp; e += kMaxThreads) {
        const int r = e / sp;
        const int c = e - r * sp;
        const long long row = row0 + r;
        const bool ok = row < m && c < sub;
        repro::cp_async4(xs + r * ldx + c, ok ? X + row * n + xcol + c : X,
                         ok);
      }
    }
    repro::cp_async_commit();
  }

  const int slabs = (sp + kTileSlab - 1) / kTileSlab;
  const int steps = ((K + kTileCodes - 1) / kTileCodes) * slabs;
  // step -> (codeword tile, column slab) into ring buffer step & 1, with
  // the rows' slab when they are streamed
  auto stage = [&](int step) {
    const int k0 = (step / slabs) * kTileCodes;
    const int s0 = (step % slabs) * kTileSlab;
    float* dst = cs + (step & 1) * kTileCodes * kLdc;
    if constexpr (XS) {
      float* xd = xs + (step & 1) * kRows * kLdc;
      if (vec) {
        constexpr int kRuns = kTileSlab / 4;
        for (int e = tid; e < kRows * kRuns; e += kMaxThreads) {
          const int r = e / kRuns;
          const int c = (e - r * kRuns) * 4;
          const long long row = row0 + r;
          const bool ok = row < m && s0 + c < sub;
          repro::cp_async16(xd + r * kLdc + c,
                            ok ? X + row * n + xcol + s0 + c : X, ok);
        }
      } else {
        for (int e = tid; e < kRows * kTileSlab; e += kMaxThreads) {
          const int r = e / kTileSlab;
          const int c = e - r * kTileSlab;
          const long long row = row0 + r;
          const bool ok = row < m && s0 + c < sub;
          repro::cp_async4(xd + r * kLdc + c,
                           ok ? X + row * n + xcol + s0 + c : X, ok);
        }
      }
    }
    if (vec) {
      constexpr int kRuns = kTileSlab / 4;
      for (int e = tid; e < kTileCodes * kRuns; e += kMaxThreads) {
        const int kk = e / kRuns;
        const int c = (e - kk * kRuns) * 4;
        const int k = k0 + kk;
        const bool ok = k < K && s0 + c < sub;
        repro::cp_async16(
            dst + kk * kLdc + c,
            ok ? Cd + static_cast<long long>(k) * sub + s0 + c : C, ok);
      }
    } else {
      for (int e = tid; e < kTileCodes * kTileSlab; e += kMaxThreads) {
        const int kk = e / kTileSlab;
        const int c = e - kk * kTileSlab;
        const int k = k0 + kk;
        const bool ok = k < K && s0 + c < sub;
        repro::cp_async4(
            dst + kk * kLdc + c,
            ok ? Cd + static_cast<long long>(k) * sub + s0 + c : C, ok);
      }
    }
  };

  float acc[RM][CW];
  float best[RM];
  int arg[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    best[i] = CUDART_INF_F;
    arg[i] = tx;   // this thread's first k: all-inf rows end at k = 0
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  }
  // norm part: codeword tid / kNormParts, kPartCols columns of each slab
  const int ncw = tid / kNormParts;
  const int npart = tid - ncw * kNormParts;
  constexpr int kPartCols = kTileSlab / kNormParts;
  float nrm = 0.f;

  stage(0);
  repro::cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage(step + 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();   // this step's slabs (and the rows) landed
    __syncthreads();
    const int tile = step / slabs;
    const int sl = step - tile * slabs;
    const int s0 = sl * kTileSlab;
    const int width = min(kTileSlab, sp - s0);   // a multiple of 4
    const float* cb = cs + (step & 1) * kTileCodes * kLdc;
    const float* xb = XS ? xs + (step & 1) * kRows * kLdc : xs + s0;
#pragma unroll
    for (int q = 0; q < kTileSlab / 4; ++q) {   // the subvector, ascending
      if (4 * q < width) {
        float4 xv[RM];
        float4 cv[CW];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          xv[i] = *reinterpret_cast<const float4*>(xb + (ty + 16 * i) * ldx +
                                                   4 * q);
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          cv[j] = *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * kLdc +
                                                   4 * q);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            float a = acc[i][j];
            a = __fmaf_rn(xv[i].x, cv[j].x, a);
            a = __fmaf_rn(xv[i].y, cv[j].y, a);
            a = __fmaf_rn(xv[i].z, cv[j].z, a);
            acc[i][j] = __fmaf_rn(xv[i].w, cv[j].w, a);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPartCols / 4; ++q) {
      const int c = npart * kPartCols + 4 * q;
      if (c < width) {
        const float4 v =
            *reinterpret_cast<const float4*>(cb + ncw * kLdc + c);
        nrm = __fmaf_rn(v.x, v.x, nrm);
        nrm = __fmaf_rn(v.y, v.y, nrm);
        nrm = __fmaf_rn(v.z, v.z, nrm);
        nrm = __fmaf_rn(v.w, v.w, nrm);
      }
    }
    if (sl == slabs - 1) {   // the tile's dot products are complete
      np[tid] = nrm;
      nrm = 0.f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < CW; ++j) {   // ascending k within this thread
        const int cw = tx + 16 * j;
        const int k = tile * kTileCodes + cw;
        const float* part = np + cw * kNormParts;
        float nk = part[0];
#pragma unroll
        for (int p = 1; p < kNormParts; ++p) nk = __fadd_rn(nk, part[p]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float s = __fmaf_rn(-2.f, acc[i][j], nk);
          if (k < K && s < best[i]) {
            best[i] = s;
            arg[i] = k;
          }
          acc[i][j] = 0.f;
        }
      }
    }
    __syncthreads();   // this step's slab and the norm parts may be reused
  }
  // the 16 lanes sharing ty are one half of a warp: reduce by (score, k)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      take_min(best[i], arg[i], ob, oa);
    }
    const long long row = row0 + ty + 16 * i;
    if (tx == 0 && row < m) codes[row * D + d] = arg[i];
  }
}

// -- launch ------------------------------------------------------------------

// The shared memory each body's layout takes; the wrapper's plan states the
// same number, and the entry refuses a plan that does not.
long long smem_bytes(int body, int K, int sp, int rm) {
  if (body == 0) return 4LL * K * (resident_ld(sp) + 1);
  const long long rows = body == 1 ? 16LL * rm * (sp + 4)
                                   : 2LL * 16 * rm * kLdc;
  return 4LL * (rows + 2 * kTileCodes * kLdc + kMaxThreads);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel>
cudaError_t go(Kernel kernel, long long blocks, int threads, long long smem,
               cudaStream_t stream, const float* X, const float* C, int* codes,
               long long m, int n, int D, int K, int sub, int arg, bool vec) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           stream>>>(X, C, codes, m, n, D, K, sub, arg, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// X: (m, n) row-major float32, C: (D, K, sub) float32 with n = D * sub,
// codes: (m, D) int32, all on the card. The plan (ops.pq_assign_plan):
// body 0 (resident, sub <= 16) with `threads` (a multiple of 32, at most
// 256), `rows` rows a thread (1, 2, 4 or 8) and `split` lanes a row (a
// power of two dividing 32); body 1 (tiled, rows kept) or 2 (tiled, rows
// streamed) with 256 threads and 16 x `rows` rows a block (rows 1, 2, 4 or
// 8); `smem`, the plan's shared memory, must be the body's. Returns a
// cudaError_t.
extern "C" int repro_pq_assign(const void* X, const void* C, void* codes,
                               long long m, int n, int D, int K, int sub,
                               int body, int threads, int rows, int split,
                               int smem, void* stream) {
  const float* x = static_cast<const float*>(X);
  const float* c = static_cast<const float*>(C);
  int* out = static_cast<int*>(codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sp = (sub + 3) / 4 * 4;
  if (smem != smem_bytes(body, K, sp, rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body == 0) {
    if (sub > 16 || threads < 32 || threads > kMaxThreads || threads % 32 ||
        split < 1 || split > 32 || (split & (split - 1)) ||
        (rows != 1 && rows != 2 && rows != 4 && rows != 8)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool vec = sub % 4 == 0 && n % 4 == 0 && aligned16(X) &&
                     aligned16(C);
    const long long per = static_cast<long long>(threads / split) * rows;
    const long long blocks = static_cast<long long>(D) * ((m + per - 1) / per);
#define REPRO_RESIDENT(S, R)                                                \
  if (sp == S && rows == R)                                                 \
    return static_cast<int>(go(&pq_resident_kernel<S, R>, blocks, threads,  \
                               smem, st, x, c, out, m, n, D, K, sub, split, \
                               vec));
    REPRO_RESIDENT(4, 1) REPRO_RESIDENT(4, 2) REPRO_RESIDENT(4, 4)
    REPRO_RESIDENT(4, 8) REPRO_RESIDENT(8, 1) REPRO_RESIDENT(8, 2)
    REPRO_RESIDENT(8, 4) REPRO_RESIDENT(8, 8) REPRO_RESIDENT(12, 1)
    REPRO_RESIDENT(12, 2) REPRO_RESIDENT(12, 4) REPRO_RESIDENT(12, 8)
    REPRO_RESIDENT(16, 1) REPRO_RESIDENT(16, 2) REPRO_RESIDENT(16, 4)
    REPRO_RESIDENT(16, 8)
#undef REPRO_RESIDENT
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((body != 1 && body != 2) || threads != kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = sub % 4 == 0 && n % 4 == 0 && aligned16(X) && aligned16(C);
  const long long blocks =
      static_cast<long long>(D) * ((m + 16LL * rows - 1) / (16LL * rows));
#define REPRO_TILED(R, XS)                                                   \
  if (rows == R && (body == 2) == XS)                                        \
    return static_cast<int>(go(&pq_tiled_kernel<R, XS>, blocks, threads,    \
                               smem, st, x, c, out, m, n, D, K, sub, sp,    \
                               vec));
  REPRO_TILED(1, false) REPRO_TILED(2, false) REPRO_TILED(4, false)
  REPRO_TILED(8, false) REPRO_TILED(8, true)
#undef REPRO_TILED
  return static_cast<int>(cudaErrorInvalidValue);
}
