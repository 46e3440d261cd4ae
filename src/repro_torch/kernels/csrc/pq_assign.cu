// Product-quantizer assignment for Hopper (sm_90a): for each row x and
// subspace d, the argmin over k of ||C[d,k]||^2 - 2 <x_d, C[d,k]>, float32,
// ties to the lowest k.
//
// Replaces the TPU kernel repro/kernels/pq_assign.py pq_assign, which fuses
// the distance product on the MXU with the argmin so the (rows, K) score
// tile never leaves VMEM.
//
// What bounds it on an H100. 2 m n K operations against 4 m n bytes of X:
// K/2 operations per byte read, 128 at K = 256, so the float32 rate bounds
// it. Tensor cores are ruled out on purpose: TF32 keeps ten mantissa bits
// and would move near-equal scores past each other, flipping codes.
//
// What the design does about it. A float32 SIMT product tile with an argmin
// epilogue. A block of 256 threads owns 64 rows of one subspace and walks
// the K codewords in tiles of 64; for each tile it stages 8-wide slabs of
// the rows and of the codewords in shared memory and each thread keeps a
// 4 x 4 block of dot products in registers, summing over the subvector in
// ascending order with plain FMAs, and the codeword norms beside them. At
// the end of a K tile each thread folds its scores into a running
// (best, index) per row with a strict <, so among equal scores the first k
// it saw wins; the 16 threads that share a row then reduce their
// candidates by (score, k). No tile needs the whole codebook or the whole
// subvector in shared memory, so the coarse quantizer's shape (K = 1024,
// sub = 256) runs through the same body. Ragged m, K and sub are masked.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kRows = 64;     // rows of one subspace per block
constexpr int kCodes = 64;    // codewords per K tile
constexpr int kSlab = 8;      // subvector columns staged at once
constexpr int kThreads = 256;  // 16 x 16, each 4 rows x 4 codewords

__global__ void __launch_bounds__(kThreads)
pq_assign_kernel(const float* __restrict__ X, const float* __restrict__ C,
                 int* __restrict__ codes, long long m, int n, int D, int K,
                 int sub) {
  __shared__ float xs[kSlab][kRows + 1];
  __shared__ float cs[kSlab][kCodes + 1];
  const int tx = threadIdx.x & 15;   // codeword group: tx + 16 j
  const int ty = threadIdx.x >> 4;   // row group: ty + 16 i
  const int d = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const float* Cd = C + static_cast<long long>(d) * K * sub;
  const long long xcol = static_cast<long long>(d) * sub;

  float best[4];
  int arg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = CUDART_INF_F;
    arg[i] = 0;
  }
  for (int k0 = 0; k0 < K; k0 += kCodes) {
    float acc[4][4];
    float cn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cn[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
    }
    for (int s0 = 0; s0 < sub; s0 += kSlab) {
      for (int e = threadIdx.x; e < kRows * kSlab; e += kThreads) {
        const int r = e / kSlab;
        const int t = e % kSlab;
        const long long row = row0 + r;
        xs[t][r] = (row < m && s0 + t < sub)
                       ? X[row * n + xcol + s0 + t] : 0.f;
      }
      for (int e = threadIdx.x; e < kCodes * kSlab; e += kThreads) {
        const int kk = e / kSlab;
        const int t = e % kSlab;
        const int k = k0 + kk;
        cs[t][kk] = (k < K && s0 + t < sub)
                        ? Cd[static_cast<long long>(k) * sub + s0 + t] : 0.f;
      }
      __syncthreads();
      const int width = min(kSlab, sub - s0);
      for (int t = 0; t < width; ++t) {   // the subvector in ascending order
        float a[4];
        float b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[t][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = cs[t][tx + 16 * j];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cn[j] = __fmaf_rn(b[j], b[j], cn[j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // ascending k within this thread
      const int k = k0 + tx + 16 * j;
      if (k < K) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float score = __fsub_rn(cn[j], 2.f * acc[i][j]);
          if (score < best[i]) {
            best[i] = score;
            arg[i] = k;
          }
        }
      }
    }
  }
  // the 16 lanes sharing ty are one half of a warp: reduce by (score, k)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (ob < best[i] || (ob == best[i] && oa < arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
    const long long row = row0 + ty + 16 * i;
    if (tx == 0 && row < m) codes[row * D + d] = arg[i];
  }
}

}  // namespace

// X: (m, n) row-major float32, C: (D, K, sub) float32 with n = D * sub,
// codes: (m, D) int32, all on the card. Returns a cudaError_t.
extern "C" int repro_pq_assign(const void* X, const void* C, void* codes,
                               long long m, int n, int D, int K, int sub,
                               void* stream) {
  const dim3 grid(static_cast<unsigned>((m + kRows - 1) / kRows),
                  static_cast<unsigned>(D));
  pq_assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(C),
      static_cast<int*>(codes), m, n, D, K, sub);
  return static_cast<int>(cudaGetLastError());
}
