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
// byte, so device memory bounds it (X read once, Y written once). At the
// path's small shapes, (256, 256) and (512, 512), the launch and one
// round trip to memory bound it instead.
//
// What the design does about it. A block owns a run of `rows` whole rows
// (ops.givens_rotate_plan: at least one block an SM, runs of up to 8 KiB,
// as few blocks as that allows, since each builds the column map anew)
// and `threads` threads. It first issues 16-byte cp.async copies of its
// whole run into shared memory, and while they are in flight builds, in
// shared memory, a map from every column to
// its partner column and coefficients (c and +s for pi[l], c and -s for
// pj[l]; unpaired columns have no partner and are copied). Then each
// thread takes four consecutive columns of a row: its own values and the
// map's entries come as one 16-byte shared load each, the partners' values
// from the staged row, so X is read from memory once, and Y is written as
// one 16-byte store. A row width that is not a multiple of 4, or an X not
// 16-byte aligned, takes the same path one column at a time. Every product
// and sum is a separately rounded __fmul_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA and Y is bit-identical to the plain PyTorch version
// (three rounded elementwise ops: c*x_i, s*x_j, their sum). Pairs must be
// disjoint; the wrapper checks it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float rotate1(float x, int q, float c, float s,
                                         const float* row) {
  return q < 0 ? x : __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, row[q]));
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
givens_rotate_kernel(const float* __restrict__ X, float* __restrict__ Y,
                     const int* __restrict__ pi, const int* __restrict__ pj,
                     const float* __restrict__ c, const float* __restrict__ s,
                     long long m, int n, int p, int rows) {
  extern __shared__ float4 smem4[];
  int* partner = reinterpret_cast<int*>(smem4);          // (n,)
  float* cs = reinterpret_cast<float*>(partner + n);     // (n,) cos
  float* sn = cs + n;                                    // (n,) signed sin
  float* xs = sn + n;                                    // (rows, n)
  constexpr int W = VEC ? 4 : 1;                         // columns a step
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const int nr = static_cast<int>(min(static_cast<long long>(rows), m - r0));
  const int steps = nr * (n / W);
  const float* src = X + r0 * n;
  for (int e = threadIdx.x; e < steps; e += blockDim.x) {
    if constexpr (VEC)
      repro::cp_async16(xs + 4 * e, src + 4 * e, true);
    else
      repro::cp_async4(xs + e, src + e, true);
  }
  repro::cp_async_commit();

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
  repro::cp_async_wait<0>();
  __syncthreads();

  float* dst = Y + r0 * n;
  for (int e = threadIdx.x; e < steps; e += blockDim.x) {
    const int row = e / (n / W);
    const int col = (e - row * (n / W)) * W;
    const float* xr = xs + row * n;
    if constexpr (VEC) {
      const float4 x = *reinterpret_cast<const float4*>(xs + 4 * e);
      const int4 q = *reinterpret_cast<const int4*>(partner + col);
      const float4 cv = *reinterpret_cast<const float4*>(cs + col);
      const float4 sv = *reinterpret_cast<const float4*>(sn + col);
      *reinterpret_cast<float4*>(dst + 4 * e) =
          make_float4(rotate1(x.x, q.x, cv.x, sv.x, xr),
                      rotate1(x.y, q.y, cv.y, sv.y, xr),
                      rotate1(x.z, q.z, cv.z, sv.z, xr),
                      rotate1(x.w, q.w, cv.w, sv.w, xr));
    } else {
      dst[e] = rotate1(xs[e], partner[col], cs[col], sn[col], xr);
    }
  }
}

// Shared memory of one block, in bytes, as ops.givens_rotate_plan counts
// it: the column map and the staged rows.
long long smem_bytes(int n, int rows) {
  return 12LL * n + 4LL * rows * n;
}

template <bool VEC>
cudaError_t launch(const void* X, void* Y, const void* pi, const void* pj,
                   const void* c, const void* s, long long m, int n, int p,
                   int rows, int threads, long long smem,
                   cudaStream_t stream) {
  auto kernel = givens_rotate_kernel<VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (m + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           stream>>>(
      static_cast<const float*>(X), static_cast<float*>(Y),
      static_cast<const int*>(pi), static_cast<const int*>(pj),
      static_cast<const float*>(c), static_cast<const float*>(s), m, n, p,
      rows);
  return cudaGetLastError();
}

}  // namespace

// X, Y: (m, n) row-major float32 on the card, Y distinct from X and 16-byte
// aligned; pi, pj: (p,) int32 disjoint columns; c, s: (p,) float32; rows
// and threads (a multiple of 32, at most 256) from ops.givens_rotate_plan,
// smem its shared memory, which must equal this file's count. Returns a
// cudaError_t.
extern "C" int repro_givens_rotate(const void* X, void* Y, const void* pi,
                                   const void* pj, const void* c,
                                   const void* s, long long m, int n, int p,
                                   int rows, int threads, long long smem,
                                   void* stream) {
  if (rows < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      smem != smem_bytes(n, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  return static_cast<int>(
      vec ? launch<true>(X, Y, pi, pj, c, s, m, n, p, rows, threads, smem, st)
          : launch<false>(X, Y, pi, pj, c, s, m, n, p, rows, threads, smem,
                          st));
}
