// ADC scans for Hopper (sm_90a): the probed-block IVF scan and the flat scan.
//
// Replaces two TPU kernels of the JAX package:
//   * repro/kernels/ivf_adc.py    ivf_adc     (probed CSR tiles, 4 bodies)
//   * repro/kernels/adc_lookup.py adc_lookup  (flat scan, 4 bodies)
// Both score uint8 PQ codes against per-query lookup tables:
//   score(q, row) = sum_d LUT[q, d, codes[row, d]]
// with an optional int8/uint8 LUT plus a [scale, offset] sidecar per
// (query, column), and an optional id column whose negative entries
// (CSR holes, tombstones) score -inf.
//
// What bounds it on an H100: bytes. Each scored row moves Dp code bytes,
// a 4-byte id and a 4-byte output and does Dp shared-memory lookups and
// adds, far below the card's compute rate, so the floor is
// (codes + ids + LUT rows + output) / 3.35 TB/s.
//
// What the design does about it. The TPU kernel expands each code tile into
// a one-hot matrix and contracts it on the MXU, because a TPU gathers
// slowly. Here the query's whole (Dp, K) table sits in shared memory as
// float32 (32 KiB at Dp = 32, K = 256) and each thread scores one code row:
// it reads the row with 16-byte loads (neighbouring threads read
// neighbouring rows, so a warp's loads are contiguous) and sums Dp lookups
// in ascending column order in float32. A quantized table is dequantized
// once, while it is loaded into shared memory, exactly as dequantize_luts
// does (q * scale, then + offset). The IVF scan gives each CUDA block a run
// of consecutive schedule steps and reloads the table only when the step's
// query changes; the search layer orders its schedule query-major, so a
// block usually loads one table for many tiles. The flat scan gives each
// block one query and a long run of rows, so a table load is spread over
// thousands of rows. Rows of a masked scan with id < 0 skip the lookups.
// Later work: more than one query per loaded code tile, TMA staging.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;

// Stage query q's (Dp, K) table into shared memory as float32.
template <typename LutT>
__device__ __forceinline__ void load_lut(float* lut_s, const LutT* lut,
                                         const float* scales, long long q,
                                         int Dp, int K) {
  const LutT* src = lut + q * Dp * K;
  const int total = Dp * K;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    float v = static_cast<float>(src[i]);
    if constexpr (!std::is_same<LutT, float>::value) {
      const float* sc = scales + (q * Dp + i / K) * 2;
      v = __fadd_rn(__fmul_rn(v, sc[0]), sc[1]);
    }
    lut_s[i] = v;
  }
}

// Score one code row against the staged table, columns in ascending order.
__device__ __forceinline__ float score_row(const float* lut_s,
                                           const uint8_t* row, int Dp, int K,
                                           bool vec16) {
  float acc = 0.f;
  if (vec16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < Dp / 16; ++c) {
      const uint4 w = __ldg(p + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int d = c * 16 + j * 4 + b;
          acc = __fadd_rn(acc, lut_s[d * K + ((words[j] >> (8 * b)) & 0xffu)]);
        }
      }
    }
  } else {
    for (int d = 0; d < Dp; ++d) {
      acc = __fadd_rn(acc, lut_s[d * K + __ldg(row + d)]);
    }
  }
  return acc;
}

template <bool MASK>
__device__ __forceinline__ float score_or_mask(const float* lut_s,
                                               const uint8_t* codes,
                                               const int32_t* ids,
                                               long long row, int Dp, int K,
                                               bool vec16) {
  if (MASK && __ldg(ids + row) < 0) return -INFINITY;
  return score_row(lut_s, codes + row * Dp, Dp, K, vec16);
}

// out[s, r] = score of row block_idx[s]*block_size + r under query
// block_query[s]; each block walks steps [s0, s0 + steps_per_block).
template <typename LutT, bool MASK>
__global__ void __launch_bounds__(kThreads)
ivf_adc_kernel(const LutT* __restrict__ lut, const float* __restrict__ scales,
               const uint8_t* __restrict__ codes,
               const int32_t* __restrict__ block_idx,
               const int32_t* __restrict__ block_query,
               const int32_t* __restrict__ ids, float* __restrict__ out,
               long long S, int Dp, int K, int block_size,
               int steps_per_block, bool vec16) {
  extern __shared__ float lut_s[];
  const long long s0 = static_cast<long long>(blockIdx.x) * steps_per_block;
  const long long s1 = min(S, s0 + steps_per_block);
  long long cur_q = -1;
  for (long long s = s0; s < s1; ++s) {
    const long long q = __ldg(block_query + s);
    if (q != cur_q) {  // uniform across the block: every thread reads q
      __syncthreads();
      load_lut<LutT>(lut_s, lut, scales, q, Dp, K);
      __syncthreads();
      cur_q = q;
    }
    const long long base = static_cast<long long>(__ldg(block_idx + s)) *
                           block_size;
    for (int r = threadIdx.x; r < block_size; r += blockDim.x) {
      out[s * block_size + r] =
          score_or_mask<MASK>(lut_s, codes, ids, base + r, Dp, K, vec16);
    }
  }
}

// out[q, row] for query q = blockIdx.y and rows
// [blockIdx.x * rows_per_block, +rows_per_block).
template <typename LutT, bool MASK>
__global__ void __launch_bounds__(kThreads)
adc_lookup_kernel(const LutT* __restrict__ lut,
                  const float* __restrict__ scales,
                  const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ ids, float* __restrict__ out,
                  long long N, int Dp, int K, int rows_per_block, bool vec16) {
  extern __shared__ float lut_s[];
  const long long q = blockIdx.y;
  load_lut<LutT>(lut_s, lut, scales, q, Dp, K);
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    out[q * N + row] =
        score_or_mask<MASK>(lut_s, codes, ids, row, Dp, K, vec16);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool rows_vec16(const void* codes, int Dp) {
  return Dp % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
}

template <typename LutT, bool MASK>
cudaError_t launch_ivf(const void* lut, const void* scales, const void* codes,
                       const void* block_idx, const void* block_query,
                       const void* ids, void* out, long long S, int Dp, int K,
                       int block_size, int steps_per_block,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(Dp) * K;
  auto kernel = ivf_adc_kernel<LutT, MASK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (S + steps_per_block - 1) / steps_per_block;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(block_idx),
      static_cast<const int32_t*>(block_query),
      static_cast<const int32_t*>(ids), static_cast<float*>(out), S, Dp, K,
      block_size, steps_per_block, rows_vec16(codes, Dp));
  return cudaGetLastError();
}

template <typename LutT, bool MASK>
cudaError_t launch_flat(const void* lut, const void* scales, const void* codes,
                        const void* ids, void* out, int b, long long N, int Dp,
                        int K, int rows_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(Dp) * K;
  auto kernel = adc_lookup_kernel<LutT, MASK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((N + rows_per_block - 1) /
                                        rows_per_block),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), N, Dp, K, rows_per_block,
      rows_vec16(codes, Dp));
  return cudaGetLastError();
}

}  // namespace

// lut_kind: 0 = float32, 1 = int8 (+ scales), 2 = uint8 (+ scales).
// ids == nullptr selects the unmasked body. Returns a cudaError_t.
extern "C" int repro_ivf_adc(const void* lut, int lut_kind, const void* scales,
                             const void* codes, const void* block_idx,
                             const void* block_query, const void* ids,
                             void* out, long long S, int Dp, int K,
                             int block_size, int steps_per_block,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = ids != nullptr;
#define REPRO_IVF(T, M)                                                   \
  launch_ivf<T, M>(lut, scales, codes, block_idx, block_query, ids, out, \
                   S, Dp, K, block_size, steps_per_block, st)
  switch (lut_kind) {
    case 0: return m ? REPRO_IVF(float, true) : REPRO_IVF(float, false);
    case 1: return m ? REPRO_IVF(int8_t, true) : REPRO_IVF(int8_t, false);
    case 2: return m ? REPRO_IVF(uint8_t, true) : REPRO_IVF(uint8_t, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_IVF
}

extern "C" int repro_adc_lookup(const void* lut, int lut_kind,
                                const void* scales, const void* codes,
                                const void* ids, void* out, int b, long long N,
                                int Dp, int K, int rows_per_block,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = ids != nullptr;
#define REPRO_FLAT(T, M) \
  launch_flat<T, M>(lut, scales, codes, ids, out, b, N, Dp, K, rows_per_block, st)
  switch (lut_kind) {
    case 0: return m ? REPRO_FLAT(float, true) : REPRO_FLAT(float, false);
    case 1: return m ? REPRO_FLAT(int8_t, true) : REPRO_FLAT(int8_t, false);
    case 2: return m ? REPRO_FLAT(uint8_t, true) : REPRO_FLAT(uint8_t, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLAT
}
