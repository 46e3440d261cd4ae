// Givens plane rotations for Hopper (sm_90a): Y = X · prod_l R_{pi[l], pj[l]}(theta_l)
// over disjoint column pairs, float32.
//
// Replaces the TPU kernel repro/kernels/givens_rotate.py givens_rotate
// together with the gather and scatter its wrapper does around it
// (repro/kernels/ops.py _apply_impl): there the pair columns are gathered
// into two (m, p) planes, rotated (ye = c xe + s xo, yo = c xo - s xe) and
// scattered back into a copy of X. Here one pass reads X and writes Y.
//
// What bounds it on an H100. Six float32 operations per (row, pair) against
// eight bytes read and written per element: far below one operation per
// byte, so device memory bounds it (X read once, Y written once).
//
// What the design does about it. Each block first builds, in shared memory,
// a map from every column to its partner column and its coefficients
// (c and +s for pi[l], c and -s for pj[l]; unpaired columns have no
// partner and are copied). It then walks whole rows: thread t reads
// column t, t + blockDim, ... so reads and writes are coalesced, and the
// partner's value comes from the same row, which the block is reading
// anyway. Every product and sum is a separately rounded __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA and Y is bit-identical
// to the plain PyTorch version (three rounded elementwise ops:
// c*x_i, s*x_j, their sum). Pairs must be disjoint; the wrapper checks it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
givens_rotate_kernel(const float* __restrict__ X, float* __restrict__ Y,
                     const int* __restrict__ pi, const int* __restrict__ pj,
                     const float* __restrict__ c, const float* __restrict__ s,
                     long long m, int n, int p, int rows_per_block) {
  extern __shared__ unsigned char smem[];
  int* partner = reinterpret_cast<int*>(smem);           // (n,)
  float* cs = reinterpret_cast<float*>(partner + n);     // (n,) cos
  float* sn = cs + n;                                    // (n,) signed sin
  for (int col = threadIdx.x; col < n; col += blockDim.x) partner[col] = -1;
  __syncthreads();
  for (int l = threadIdx.x; l < p; l += blockDim.x) {
    const int i = pi[l];
    const int j = pj[l];
    const float cl = c[l];
    const float sl = s[l];
    partner[i] = j;  // y_i = c x_i + s x_j
    cs[i] = cl;
    sn[i] = sl;
    partner[j] = i;  // y_j = c x_j - s x_i = c x_j + (-s) x_i
    cs[j] = cl;
    sn[j] = -sl;
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long row_end = min(row0 + rows_per_block, m);
  for (long long r = row0; r < row_end; ++r) {
    const float* x = X + r * n;
    float* y = Y + r * n;
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      const int q = partner[col];
      const float xv = x[col];
      y[col] = q < 0 ? xv
                     : __fadd_rn(__fmul_rn(cs[col], xv),
                                 __fmul_rn(sn[col], x[q]));
    }
  }
}

}  // namespace

// X, Y: (m, n) row-major float32 on the card, Y distinct from X; pi, pj:
// (p,) int32 disjoint columns; c, s: (p,) float32. Returns a cudaError_t.
extern "C" int repro_givens_rotate(const void* X, void* Y, const void* pi,
                                   const void* pj, const void* c,
                                   const void* s, long long m, int n, int p,
                                   int rows_per_block, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 12;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        givens_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (m + rows_per_block - 1) / rows_per_block;
  givens_rotate_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<float*>(Y),
      static_cast<const int*>(pi), static_cast<const int*>(pj),
      static_cast<const float*>(c), static_cast<const float*>(s), m, n, p,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
