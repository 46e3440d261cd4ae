// ADC scans for Hopper (sm_90a): the probed-block IVF scan, the flat scan
// and the grouped KV-cache scan.
//
// Replaces three TPU kernels of the JAX package:
//   * repro/kernels/ivf_adc.py    ivf_adc     (probed CSR tiles, 4 bodies)
//   * repro/kernels/adc_lookup.py adc_lookup  (flat scan, 4 bodies)
//   * repro/kernels/adc_batch.py  adc_batch   (grouped scan, 2 bodies)
// All score uint8 PQ codes against lookup tables:
//   score(q, row) = sum_d LUT[q, d, codes[row, d]]
// with an optional int8/uint8 LUT plus a [scale, offset] sidecar per
// (query, column). The two index scans take an optional id column whose
// negative entries (CSR holes, tombstones) score -inf.
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
//
// The grouped scan (KV-cache decode attention) has g groups, one per
// (batch, kv-head) pair, each with its own S code rows and r tables (the
// GQA repetition). A block takes one group, up to kMaxTables of its tables
// (fewer when they would not fit in shared memory: r = 12, Dp = 24 is
// 288 KiB) and a run of rows; each thread reads a code row once and scores
// it against every staged table, so the codes cross the bus once per chunk
// of tables, not once per table. Neighbouring threads write neighbouring s
// of out[g, r, S]. At the long-context decode shape (g = 16, r = 1,
// S = 524,288, Dp = 16) the codes are 134 MB a launch against a 16 KiB
// table, so the floor is the code read.
// Later work: more than one query per loaded code tile, TMA staging.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTables = 8;  // tables of a group one block stages
constexpr int kMaxBatchThreads = 1024;  // block size bound of the grouped scan

// Stage `tables` consecutive (Dp, K) tables, from table q on, into shared
// memory as float32.
template <typename LutT>
__device__ __forceinline__ void load_lut(float* lut_s, const LutT* lut,
                                         const float* scales, long long q,
                                         int Dp, int K, int tables = 1) {
  const LutT* src = lut + q * Dp * K;
  const int total = tables * Dp * K;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    float v = static_cast<float>(src[i]);
    if constexpr (!std::is_same<LutT, float>::value) {
      const float* sc = scales + (q * Dp + i / K) * 2;
      v = __fadd_rn(__fmul_rn(v, sc[0]), sc[1]);
    }
    lut_s[i] = v;
  }
}

// Score one code row against `tables` staged tables (table t at
// lut_s + t * Dp * K, t < RC), columns in ascending order, into acc[t].
template <int RC>
__device__ __forceinline__ void score_tables(float (&acc)[RC],
                                             const float* lut_s,
                                             const uint8_t* row, int Dp,
                                             int K, bool vec16, int tables) {
  const int stride = Dp * K;
#pragma unroll
  for (int t = 0; t < RC; ++t) acc[t] = 0.f;
  if (vec16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < Dp / 16; ++c) {
      const uint4 w = __ldg(p + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int at = (c * 16 + j * 4 + b) * K +
                         ((words[j] >> (8 * b)) & 0xffu);
#pragma unroll
          for (int t = 0; t < RC; ++t) {
            if (t < tables) acc[t] = __fadd_rn(acc[t], lut_s[t * stride + at]);
          }
        }
      }
    }
  } else {
    for (int d = 0; d < Dp; ++d) {
      const int at = d * K + __ldg(row + d);
#pragma unroll
      for (int t = 0; t < RC; ++t) {
        if (t < tables) acc[t] = __fadd_rn(acc[t], lut_s[t * stride + at]);
      }
    }
  }
}

// Score one code row against the staged table, columns in ascending order.
__device__ __forceinline__ float score_row(const float* lut_s,
                                           const uint8_t* row, int Dp, int K,
                                           bool vec16) {
  float acc[1];
  score_tables<1>(acc, lut_s, row, Dp, K, vec16, 1);
  return acc[0];
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

// out[gi, j, s] for group gi = blockIdx.y / chunks, its tables
// j in [j0, j0 + chunk) with j0 = (blockIdx.y % chunks) * chunk, and rows
// s in [blockIdx.x * rows_per_block, +rows_per_block).
template <typename LutT, int RC>
__global__ void __launch_bounds__(kMaxBatchThreads)
adc_batch_kernel(const LutT* __restrict__ lut,
                 const float* __restrict__ scales,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int r, long long S, int Dp, int K, int chunk,
                 int rows_per_block, bool vec16) {
  extern __shared__ float lut_s[];
  const int chunks = (r + chunk - 1) / chunk;
  const long long gi = blockIdx.y / chunks;
  const int j0 = (blockIdx.y % chunks) * chunk;
  const int tables = min(chunk, r - j0);
  load_lut<LutT>(lut_s, lut, scales, gi * r + j0, Dp, K, tables);
  __syncthreads();
  const long long s0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long s1 = min(S, s0 + rows_per_block);
  float* o = out + (gi * r + j0) * S;
  for (long long s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    float acc[RC];
    score_tables<RC>(acc, lut_s, codes + (gi * S + s) * Dp, Dp, K, vec16,
                     tables);
#pragma unroll
    for (int t = 0; t < RC; ++t) {
      if (t < tables) o[t * S + s] = acc[t];
    }
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

template <typename LutT, int RC>
cudaError_t launch_batch(const void* lut, const void* scales,
                         const void* codes, void* out, int g, int r,
                         long long S, int Dp, int K, int chunk,
                         int rows_per_block, int threads,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(chunk) * Dp * K;
  auto kernel = adc_batch_kernel<LutT, RC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (r + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>((S + rows_per_block - 1) /
                                        rows_per_block),
                  static_cast<unsigned>(g * chunks));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), r, S, Dp,
      K, chunk, rows_per_block, rows_vec16(codes, Dp));
  return cudaGetLastError();
}

template <typename LutT>
cudaError_t launch_batch_tables(const void* lut, const void* scales,
                                const void* codes, void* out, int g, int r,
                                long long S, int Dp, int K, int chunk,
                                int rows_per_block, int threads,
                                cudaStream_t stream) {
  if (threads < 1 || threads > kMaxBatchThreads) return cudaErrorInvalidValue;
#define REPRO_BATCH(RC)                                                   \
  launch_batch<LutT, RC>(lut, scales, codes, out, g, r, S, Dp, K, chunk, \
                         rows_per_block, threads, stream)
  if (chunk <= 1) return REPRO_BATCH(1);
  if (chunk <= 2) return REPRO_BATCH(2);
  if (chunk <= 4) return REPRO_BATCH(4);
  if (chunk <= kMaxTables) return REPRO_BATCH(kMaxTables);
  return cudaErrorInvalidValue;
#undef REPRO_BATCH
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

// out (g, r, S) float32; `chunk` tables of a group per block (at most
// kMaxTables, and chunk * Dp * K floats must fit in shared memory), blocks
// of `threads` threads (at most kMaxBatchThreads) over `rows_per_block`
// rows (kernels/ops.py sizes both: more threads where one block fills an
// SM's shared memory, shorter runs where the grid would be thin).
extern "C" int repro_adc_batch(const void* lut, int lut_kind,
                               const void* scales, const void* codes,
                               void* out, int g, int r, long long S, int Dp,
                               int K, int chunk, int rows_per_block,
                               int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TABLES(T)                                                   \
  launch_batch_tables<T>(lut, scales, codes, out, g, r, S, Dp, K, chunk, \
                         rows_per_block, threads, st)
  switch (lut_kind) {
    case 0: return REPRO_TABLES(float);
    case 1: return REPRO_TABLES(int8_t);
    case 2: return REPRO_TABLES(uint8_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TABLES
}
