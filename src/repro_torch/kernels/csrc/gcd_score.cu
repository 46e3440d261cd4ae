// GCD score field for Hopper (sm_90a): A = G^T R - R^T G, float32.
//
// Replaces the TPU kernel repro/kernels/gcd_score.py gcd_score, which
// computes, for each output tile (I, J), both G[:, I]^T R[:, J] (a tile of
// M = G^T R) and G[:, J]^T R[:, I] (the matching tile of M^T) and writes
// their difference, so M is never written to memory.
//
// What bounds it on an H100. At the slice's n = 256 the function is one
// 256^3 product (about 33 MFLOP) over 768 KiB of operands: half a
// microsecond at the float32 rate and less in bytes, so a launch (a few
// microseconds) bounds it. Plain float32 FMAs are used on purpose and not
// TF32 tensor cores: GCD takes the argmax of |A| to pick its Givens pairs,
// and TF32's 10-bit mantissa would reorder near-equal entries and flip the
// greedy matching.
//
// What the design does about it. One launch computes the whole field with a
// shared-memory tiled product: a 16 x 16 block owns output tile (I, J) and
// walks the contraction in 16-row slabs, staging G and R columns of both I
// and J. Thread (i, j) accumulates M[I+i, J+j] and M[J+j, I+i] over the
// same slabs in the same order, so the tile owning (J, I) computes the same
// two sums swapped and A comes out exactly antisymmetric with a zero
// diagonal. Any n works: loads outside the matrix read 0 and stores outside
// it are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
gcd_score_kernel(const float* __restrict__ G, const float* __restrict__ R,
                 float* __restrict__ A, int n) {
  __shared__ float g_i[kTile][kTile + 1];
  __shared__ float r_i[kTile][kTile + 1];
  __shared__ float g_j[kTile][kTile + 1];
  __shared__ float r_j[kTile][kTile + 1];
  const int tx = threadIdx.x;  // output column within the tile
  const int ty = threadIdx.y;  // output row within the tile
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float acc = 0.f;   // M[i0 + ty, j0 + tx]   = sum_k G[k, i] R[k, j]
  float accT = 0.f;  // M[j0 + tx, i0 + ty]   = sum_k G[k, j] R[k, i]
  for (int k0 = 0; k0 < n; k0 += kTile) {
    const int k = k0 + ty;
    const bool krow = k < n;
    const long long rowk = static_cast<long long>(k) * n;
    const bool ci = krow && i0 + tx < n;
    const bool cj = krow && j0 + tx < n;
    g_i[ty][tx] = ci ? G[rowk + i0 + tx] : 0.f;
    r_i[ty][tx] = ci ? R[rowk + i0 + tx] : 0.f;
    g_j[ty][tx] = cj ? G[rowk + j0 + tx] : 0.f;
    r_j[ty][tx] = cj ? R[rowk + j0 + tx] : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      acc = __fmaf_rn(g_i[kk][ty], r_j[kk][tx], acc);
      accT = __fmaf_rn(g_j[kk][tx], r_i[kk][ty], accT);
    }
    __syncthreads();
  }
  if (i0 + ty < n && j0 + tx < n) {
    A[static_cast<long long>(i0 + ty) * n + j0 + tx] = acc - accT;
  }
}

}  // namespace

// G, R, A: (n, n) row-major float32 on the card. Returns a cudaError_t.
extern "C" int repro_gcd_score(const void* G, const void* R, void* A, int n,
                               void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  gcd_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(R),
      static_cast<float*>(A), n);
  return static_cast<int>(cudaGetLastError());
}
