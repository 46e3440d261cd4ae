// GCD score field for Hopper (sm_90a): A = G^T R - R^T G, float32.
//
// Replaces the TPU kernel repro/kernels/gcd_score.py gcd_score, which
// computes, for each output tile (I, J), both G[:, I]^T R[:, J] (a tile of
// M = G^T R) and G[:, J]^T R[:, I] (the matching tile of M^T) and writes
// their difference, so M is never written to memory.
//
// What bounds it on an H100. The function is one n^3 product (2 n^3
// operations) over 12 n^2 bytes: 0.5 us at the float32 rate at the serving
// slice's n = 256 and 4.0 us at the training slice's n = 512, so operations
// bound it, and at n = 256 a launch (about a microsecond) is as long as the
// work. Plain float32 FMAs are used on purpose and not TF32 tensor cores:
// GCD takes the argmax of |A| to pick its Givens pairs, and TF32's 10-bit
// mantissa would reorder near-equal entries and flip the greedy matching.
//
// What the design does about it.
//  * Each product entry once. One block per tile pair (I, J) with I <= J,
//    decoded from the block index row by row over the upper triangle:
//    half of each thread group sums the tile P = M[I, J], the
//    other half the tile Q = M[J, I]^T. The block writes A[I, J] = P - Q
//    and A[J, I] = -(P - Q) from the same values, so A is exactly
//    antisymmetric and the FMAs are the n^3 the function needs, not twice
//    that. A diagonal tile sums P only and writes P - P^T through shared
//    memory: fl(a - b) = -fl(b - a), and the diagonal is exactly 0.
//  * Register tiles. Each thread owns TM x TN entries of its product and
//    reads them as float2/float4 from shared memory, so one shared read
//    feeds two to four FMAs; all lanes of a warp read the same contraction
//    row, so the reads are broadcasts or distinct banks.
//  * Two contraction groups. One block an SM leaves few warps to hide
//    latency, so KG = 2 groups each sum every other slab of kSlab
//    contraction rows (ascending within the group) and the two sums are
//    added in group order at the end: a fixed order, so the result does not
//    vary from run to run.
//  * Copies in flight. The four column panels G_I, R_J, R_I, G_J stream
//    through a ring of stages of KG slabs with cp.async (16 bytes when
//    n % 4 == 0): the whole contraction is in flight at once up to
//    n = 256, three stages of 64 rows above.
//  * Tile width from n (the wrapper's ops.gcd_score_tile). 16-wide tiles
//    (2 x 2 a thread) up to n = 256 and 32-wide (4 x 4) above, 256
//    threads either way, so n = 256 and n = 512 both give 136 pairs for
//    the 132 SMs. Ragged n: loads outside the matrix stage zeros and
//    stores outside it are skipped.
// Measured on an H100 (kernel_bench.py --split, PERF.md), the panel copies
// alone and the contraction alone each take between half and three
// quarters of the kernel's time at n = 256 and 512: both halves bound it,
// far above the float32 bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kSlab = 32;    // contraction rows per group per ring stage

// T: tile width; TM x TN: entries of one product per thread; S: stages in
// the copy ring; KG: contraction groups (thread groups that each sum one
// kSlab-row slab of every stage, added in group order at the end).
template <int T, int TM, int TN, int S, int KG>
struct Plan {
  static constexpr int kHalf = (T / TM) * (T / TN);  // threads per product
  static constexpr int kGroup = 2 * kHalf;           // threads per group
  static constexpr int kThreads = KG * kGroup;
  static constexpr int kPanel = kSlab * T;           // floats per panel slab
  static constexpr int kStage = KG * 4 * kPanel;     // floats per stage
  static constexpr int kSmem = S * kStage * sizeof(float);
  static constexpr int kLd = T + 1;                  // epilogue tile row
  static_assert(T % 4 == 0 && T % TM == 0 && T % TN == 0, "tile shape");
  static_assert(kHalf % 32 == 0, "a warp computes one product");
  static_assert(S >= 2 && T * kLd + (KG - 1) * 2 * T * T <= S * kStage,
                "the epilogue fits in the ring");
};

template <int W>
__device__ __forceinline__ void load_run(const float* p, float (&v)[W]) {
  static_assert(W == 2 || W == 4, "float2 or float4 runs");
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int T, int TM, int TN, int S, int KG>
__global__ void __launch_bounds__(Plan<T, TM, TN, S, KG>::kThreads)
gcd_score_kernel(const float* __restrict__ G, const float* __restrict__ R,
                 float* __restrict__ A, int n, int tiles, bool vec) {
  using P = Plan<T, TM, TN, S, KG>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // pair index -> (I, J), I <= J, row by row over the upper triangle
  int pair = blockIdx.x;
  int I = 0;
  while (pair >= tiles - I) {
    pair -= tiles - I;
    ++I;
  }
  const int J = I + pair;
  const bool diag = I == J;
  const int i0 = I * T;
  const int j0 = J * T;
  const int tid = threadIdx.x;
  const int group = tid / P::kGroup;
  const int within = tid - group * P::kGroup;
  const int half = within / P::kHalf;  // 0: P = G_I^T R_J, 1: Q = R_I^T G_J
  const int t = within - half * P::kHalf;
  const int a0 = (t / (T / TN)) * TM;
  const int b0 = (t % (T / TN)) * TN;
  const int stages = (n + KG * kSlab - 1) / (KG * kSlab);

  // Stage s holds contraction rows s*KG*kSlab .. + KG*kSlab as KG slabs of
  // four panels of kSlab x T: 0 = G_I, 1 = R_J, 2 = R_I, 3 = G_J (columns
  // i0.. or j0..); group g sums slab g of every stage.
  auto stage = [&](int s) {
    float* dst = smem + (s % S) * P::kStage;
    const int k0 = s * KG * kSlab;
    if (vec) {
      constexpr int kRow = T / 4;                 // 16-byte chunks per row
      for (int c = tid; c < KG * 4 * kSlab * kRow; c += P::kThreads) {
        const int q = c / (kSlab * kRow);         // slab * 4 + panel
        const int w = c - q * (kSlab * kRow);
        const int r = w / kRow;
        const int col = (w - r * kRow) * 4;
        const int panel = q & 3;
        const float* src = (panel == 0 || panel == 3) ? G : R;
        const int c0 = (panel & 1) ? j0 : i0;
        const int k = k0 + (q >> 2) * kSlab + r;
        const bool ok = k < n && c0 + col < n;
        repro::cp_async16(
            dst + q * P::kPanel + r * T + col,
            ok ? src + static_cast<long long>(k) * n + c0 + col : src, ok);
      }
    } else {
      for (int e = tid; e < P::kStage; e += P::kThreads) {
        const int q = e / P::kPanel;
        const int w = e - q * P::kPanel;
        const int r = w / T;
        const int col = w - r * T;
        const int panel = q & 3;
        const float* src = (panel == 0 || panel == 3) ? G : R;
        const int c0 = (panel & 1) ? j0 : i0;
        const int k = k0 + (q >> 2) * kSlab + r;
        const bool ok = k < n && c0 + col < n;
        repro::cp_async4(
            dst + e, ok ? src + static_cast<long long>(k) * n + c0 + col : src,
            ok);
      }
    }
  };

  const int lp = group * 4 + (half ? 2 : 0);  // G_I for P, R_I for Q
  const int rp = group * 4 + (half ? 3 : 1);  // R_J for P, G_J for Q
  const bool active = !(diag && half);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < stages) stage(s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    repro::cp_async_wait<S - 2>();   // stage s has landed
    __syncthreads();                 // and stage s - 1 is consumed
    if (s + S - 1 < stages) stage(s + S - 1);
    repro::cp_async_commit();
    if (active) {
      const float* base = smem + (s % S) * P::kStage;
      const float* lhs = base + lp * P::kPanel + a0;
      const float* rhs = base + rp * P::kPanel + b0;
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk) {   // the slab, ascending
        float a[TM];
        float b[TN];
        load_run<TM>(lhs + kk * T, a);
        load_run<TN>(rhs + kk * T, b);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          }
        }
      }
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();   // the ring is free for the epilogue

  constexpr int kLd = P::kLd;
  float* tile = smem;                 // T x kLd
  float* part = smem + T * kLd;       // (KG - 1) x 2 x T x T group sums
  if (KG > 1) {
    if (group > 0 && active) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          part[((group - 1) * 2 + half) * T * T + (a0 + i) * T + b0 + j] =
              acc[i][j];
        }
      }
    }
    __syncthreads();
    if (group == 0 && active) {
      for (int g = 1; g < KG; ++g) {   // the groups' sums in group order
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = __fadd_rn(
                acc[i][j],
                part[((g - 1) * 2 + half) * T * T + (a0 + i) * T + b0 + j]);
          }
        }
      }
    }
  }
  if (diag) {
    if (group == 0 && half == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) tile[(a0 + i) * kLd + b0 + j] = acc[i][j];
      }
    }
    __syncthreads();
    for (int e = tid; e < T * T; e += P::kThreads) {
      const int r = e / T;
      const int c = e - r * T;
      if (i0 + r < n && i0 + c < n) {
        A[static_cast<long long>(i0 + r) * n + i0 + c] =
            __fsub_rn(tile[r * kLd + c], tile[c * kLd + r]);
      }
    }
  } else {
    if (group == 0 && half == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) tile[(a0 + i) * kLd + b0 + j] = acc[i][j];
      }
    }
    __syncthreads();
    if (group == 0 && half == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float& q = tile[(a0 + i) * kLd + b0 + j];
          q = __fsub_rn(acc[i][j], q);   // A[i0 + a, j0 + b]
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < T * T; e += P::kThreads) {
      const int r = e / T;
      const int c = e - r * T;
      if (i0 + r < n && j0 + c < n) {
        A[static_cast<long long>(i0 + r) * n + j0 + c] = tile[r * kLd + c];
      }
      if (j0 + r < n && i0 + c < n) {
        A[static_cast<long long>(j0 + r) * n + i0 + c] = -tile[c * kLd + r];
      }
    }
  }
}

template <int T, int TM, int TN, int S, int KG>
cudaError_t launch(const float* G, const float* R, float* A, int n,
                   cudaStream_t stream) {
  using P = Plan<T, TM, TN, S, KG>;
  auto kernel = gcd_score_kernel<T, TM, TN, S, KG>;
  if (P::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (n + T - 1) / T;
  const long long pairs = static_cast<long long>(tiles) * (tiles + 1) / 2;
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(G) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  kernel<<<static_cast<unsigned>(pairs), P::kThreads, P::kSmem, stream>>>(
      G, R, A, n, tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// G, R, A: (n, n) row-major float32 on the card; tile: 16 or 32 (the
// wrapper's plan). Returns a cudaError_t.
extern "C" int repro_gcd_score(const void* G, const void* R, void* A, int n,
                               int tile, void* stream) {
  const float* g = static_cast<const float*>(G);
  const float* r = static_cast<const float*>(R);
  float* a = static_cast<float*>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {   // 64 KiB and 96 KiB rings, 256 threads
    case 16: return static_cast<int>(launch<16, 2, 2, 4, 2>(g, r, a, n, st));
    case 32: return static_cast<int>(launch<32, 4, 4, 3, 2>(g, r, a, n, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
