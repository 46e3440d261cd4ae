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
// What bounds it on an H100. The bytes (codes, ids, LUT rows and output
// over 3.35 TB/s) are a floor the two index scans do not reach: every
// code byte is a lookup in a table in shared memory, and a warp's 32
// lookups of one column fall on random banks, so a 4-byte lookup costs
// about 3.2 shared-memory wavefronts a warp (kernel_bench.py counts them on
// the real codes). That shared-gather floor, not the bytes, is what the
// scans are built against.
//
// What the design does about it. The TPU kernel expands each code tile into
// a one-hot matrix and contracts it on the MXU, because a TPU gathers
// slowly. Here a query's whole (Dp, K) table sits in shared memory as
// float32 (32 KiB at Dp = 32, K = 256) and each thread scores one code row:
// it reads the row with 16-byte loads (neighbouring threads read
// neighbouring rows, so a warp's loads are contiguous) and sums Dp lookups
// in ascending column order in float32, as the plain versions do, so the
// results are bit-equal to them. A quantized table is dequantized once,
// while it is staged, exactly as dequantize_luts does (q * scale, then
// + offset); a float32 table is staged by 16-byte cp.async copies, an
// int8/uint8 one by 16-byte loads of 16 entries of one column.
//
//   * The IVF scan (ivf_adc) takes 512-thread blocks, scoring 512 rows
//     (four 128-row tiles) at once, over a run of schedule steps.
//     kernels/ops.py ivf_adc_plan cuts each query's steps of the
//     search layer's query-major schedule into runs that never cross a
//     query, about four resident waves of them, so a block stages one
//     table (fixed runs of up to 64 steps straddled queries, and staged
//     one every few steps at small batches). A block keeps its run's tile
//     and query numbers in shared memory, so a row's only global reads
//     are its id and then, if it is live, its codes. Any other schedule
//     still scores right: the block restages wherever the query changes.
//     Rows whose id is < 0 (holes, tombstones, the sentinel tile's) write
//     -inf, read no codes and look nothing up.
//   * The flat scan (adc_lookup) stages up to four queries' tables in one
//     block, interleaved so entry (d, k) of the four is one float4: each
//     code row is read once for four queries (not once a query), and one
//     16-byte shared load serves four lookups, which costs fewer wavefronts
//     a lookup than four 4-byte loads (eight lanes a phase over eight bank
//     groups). kernels/ops.py adc_lookup_plan sizes the chunks (two
//     queries where four tables do not fit, Dp = 64), the threads and the
//     row runs; the chunks of a row run sit side by side in the grid, so
//     they share its codes in L2.
//
// The grouped scan (adc_batch, KV-cache decode attention) has g groups, one
// per (batch, kv-head) pair, each with its own S code rows and r tables (the
// GQA repetition: r = 1 for olmo-1b and qwen1.5-4b, 5 for llama4-maverick, 6
// for grok-1, 12 for nemotron-4). It replaces repro/kernels/adc_batch.py
// adc_batch, whose TPU body expands each code tile into a one-hot matrix
// for the MXU (adc_common.adc_tile_scores). At r = 1 (g = 16, S = 524,288,
// Dp = 16) the floor is the 134 MB code read against a 16 KiB table. At
// r > 1 the r tables share every code byte, so the codes are read once per
// chunk of tables and the shared-gather floor bounds the kernel, not the
// bytes: r separate 4-byte lookups a code byte cost r times 3.2 wavefronts
// a warp. So a block stages its chunk of a group's tables as planes of
// four, entry (d, k) of the four one float4 (the flat scan's stage_tables
// and add_entry), then a plane of two (float2) and one of one for the rest
// of the chunk: a code byte costs ceil(r / 4) wide loads (2 at r = 5 or 6,
// 3 at r = 12), not r narrow ones, and a float4 lookup spreads a phase's
// eight lanes over the eight 16-byte bank groups (10.2 wavefronts a warp
// for four tables on uniform codes, against 12.6 for four 4-byte ones).
// kernels/ops.py adc_batch_plan picks the chunk (the tables that fit in
// shared memory, in the layout of fewest wavefronts: 12 tables of Dp = 24 do
// not fit, and three chunks of four beat two of six), the threads, the row
// runs and the grid; the chunks of a row run sit side by side in the grid,
// so they share its codes in L2. Each table's sum is float32 from 0 in
// ascending column order, as the plain version adds, so the result is
// bit-equal to it. Rows of a multiple of 16 (8) bytes are read by 16-byte
// (8-byte) loads.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kIvfThreads = 512;      // threads per block of the IVF scan
constexpr int kIvfMinBlocks = 3;      // of them resident on an SM, at least
constexpr int kIvfWindow = 256;       // schedule steps a block holds at once
constexpr int kFlatMaxThreads = 1024;  // block size bound of the flat scan
constexpr int kBatchMaxTables = 12;  // tables of a group one block stages
constexpr int kMaxBatchThreads = 1024;  // block size bound of the grouped scan
// Chunks of up to this many float32 tables are compiled for two resident
// blocks of kMaxBatchThreads (32 registers a thread), so two 1024-thread
// blocks of four or five tables (64 or 80 KiB) fill an SM with 64 warps.
// An int8/uint8 pack's dequantizing stage would spill at 32 registers; its
// blocks keep the registers they need (one 1024-thread block an SM).
constexpr int kBatchWideTables = 5;

// -- the two index scans ----------------------------------------------------

// Entry i = d * K + k of table q, dequantized as dequantize_luts does.
template <typename LutT>
__device__ __forceinline__ float lut_entry(const LutT* lut,
                                           const float* scales, long long q,
                                           int DK, int K, int i) {
  float v = static_cast<float>(__ldg(lut + q * DK + i));
  if constexpr (!std::is_same<LutT, float>::value) {
    const float* sc = scales + (q * (DK / K) + i / K) * 2;
    v = __fadd_rn(__fmul_rn(v, __ldg(sc)), __ldg(sc + 1));
  }
  return v;
}

// Stage one int8/uint8 (Dp, K) table, K a multiple of 16, from 16-byte
// aligned `src` into shared memory as float32, dequantized as
// dequantize_luts does: each thread takes 16 entries of one column from one
// 16-byte load, and that column's scale and offset (`sc`: the table's
// (Dp, 2) pack), where the entry-by-entry loop issues three loads an entry.
template <typename LutT>
__device__ __forceinline__ void stage_quantized16(float* lut_s,
                                                  const LutT* src,
                                                  const float* sc, int DK,
                                                  int K) {
  const uint4* src16 = reinterpret_cast<const uint4*>(src);
  float4* dst = reinterpret_cast<float4*>(lut_s);
  for (int c = threadIdx.x; c < DK / 16; c += blockDim.x) {
    const uint4 w = __ldg(src16 + c);
    const int d = 16 * c / K;
    const float scale = __ldg(sc + 2 * d), offset = __ldg(sc + 2 * d + 1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const LutT e = static_cast<LutT>((words[j] >> (8 * b)) & 0xffu);
        v[b] = __fadd_rn(__fmul_rn(static_cast<float>(e), scale), offset);
      }
      dst[4 * c + j] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Stage tables q0 .. q0 + tables - 1 (tables <= RC) into shared memory as
// float32, interleaved: entry i of table t at lut_s[i * RC + t], so one
// RC-wide shared load serves RC queries. Slots t >= tables hold zeros. A
// single table goes by 16-byte loads where it can: a float32 one by
// cp.async copies, an int8/uint8 one by stage_quantized16.
template <typename LutT, int RC>
__device__ __forceinline__ void stage_tables(float* lut_s, const LutT* lut,
                                             const float* scales,
                                             long long q0, int tables,
                                             int DK, int K) {
  if constexpr (RC == 1) {
    const LutT* src = lut + q0 * DK;
    const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
    if constexpr (std::is_same<LutT, float>::value) {
      if (DK % 4 == 0 && aligned) {
        for (int c = threadIdx.x; c < DK / 4; c += blockDim.x)
          repro::cp_async16(lut_s + 4 * c, src + 4 * c, true);
        repro::cp_async_commit();
        repro::cp_async_wait<0>();
        return;
      }
    } else {
      if (K % 16 == 0 && aligned) {
        stage_quantized16<LutT>(lut_s, src, scales + q0 * (DK / K) * 2, DK,
                                K);
        return;
      }
    }
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < DK; i += blockDim.x) {
    float v[RC];
#pragma unroll
    for (int t = 0; t < RC; ++t)
      v[t] = t < tables ? lut_entry<LutT>(lut, scales, q0 + t, DK, K, i)
                        : 0.f;
    if constexpr (RC == 4) {
      reinterpret_cast<float4*>(lut_s)[i] = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    } else if constexpr (RC == 2) {
      reinterpret_cast<float2*>(lut_s)[i] = make_float2(v[0], v[1]);
    } else {
      lut_s[i] = v[0];
    }
  }
}

// acc[t] += entry `at` of staged table t, for the RC interleaved tables.
template <int RC>
__device__ __forceinline__ void add_entry(float* acc, const float* lut_s,
                                          int at) {
  if constexpr (RC == 4) {
    const float4 v = reinterpret_cast<const float4*>(lut_s)[at];
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  } else if constexpr (RC == 2) {
    const float2 v = reinterpret_cast<const float2*>(lut_s)[at];
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
  } else {
    acc[0] = __fadd_rn(acc[0], lut_s[at]);
  }
}

// A code row's id and, if it is live, its first two 16-byte words (all of
// a row up to 32 bytes wide), both loads issued before any lookup. A
// masked row's codes are not read: in the IVF scan about half the steps
// are the sentinel tile, and the codes of live rows already cross L2
// once for every query that probes them.
struct RowHead {
  int id;
  uint4 w0, w1;
};

template <bool MASK>
__device__ __forceinline__ RowHead read_head(const uint8_t* codes,
                                             const int32_t* ids,
                                             long long row, int Dp,
                                             bool vec16) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* p = reinterpret_cast<const uint4*>(codes + row * Dp);
  RowHead h;
  h.id = MASK ? __ldg(ids + row) : 0;
  const bool live = !MASK || h.id >= 0;
  h.w0 = vec16 && live ? __ldg(p) : zero;
  h.w1 = vec16 && live && Dp >= 32 ? __ldg(p + 1) : zero;
  return h;
}

// acc += the 16 lookups of code word w (columns 16c .. 16c + 15), in order.
template <int RC>
__device__ __forceinline__ void add_word(float (&acc)[RC],
                                         const float* lut_s, uint4 w, int c,
                                         int K) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      add_entry<RC>(acc, lut_s, (c * 16 + j * 4 + b) * K +
                                    ((words[j] >> (8 * b)) & 0xffu));
  }
}

// Score the code row `row` (its head already read) against the RC staged
// tables, columns in ascending order, each query's sum in float32 from 0
// (the plain versions' order).
template <int RC>
__device__ __forceinline__ void score_row(float (&acc)[RC],
                                          const float* lut_s,
                                          const RowHead& h,
                                          const uint8_t* row, int Dp, int K,
                                          bool vec16) {
#pragma unroll
  for (int t = 0; t < RC; ++t) acc[t] = 0.f;
  if (vec16) {
    add_word<RC>(acc, lut_s, h.w0, 0, K);
    if (Dp >= 32) add_word<RC>(acc, lut_s, h.w1, 1, K);
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int c = 2; c < Dp / 16; ++c)
      add_word<RC>(acc, lut_s, __ldg(p + c), c, K);
  } else {
    for (int d = 0; d < Dp; ++d)
      add_entry<RC>(acc, lut_s, d * K + __ldg(row + d));
  }
}

// Score row r of window step i (its head read) and write it; masked rows
// write -inf and look nothing up.
template <bool MASK>
__device__ __forceinline__ void ivf_row(float* o, const float* lut_s,
                                        const RowHead& h,
                                        const uint8_t* codes, long long row,
                                        int r, int Dp, int K, bool vec16) {
  float v = -INFINITY;
  if (!MASK || h.id >= 0) {
    float acc[1];
    score_row<1>(acc, lut_s, h, codes + row * Dp, Dp, K, vec16);
    v = acc[0];
  }
  o[r] = v;
}

// out[s, r] = score of row block_idx[s] * bs + r under query
// block_query[s]. Block x takes the run of steps [s0, s1): with
// spq > 0 (a query-major schedule of spq steps a query) run j of query q,
// cut so that no run crosses a query; else run x of the schedule. The
// block copies the tiles and queries of up to kIvfWindow steps of its run
// into shared memory at a time, and checks whether they all have one
// query. If so (always, for a query-aligned run) it stages that query's
// table once and its threads score the window's rows, one a thread at a
// time (four 128-row tiles at once). Otherwise each pass of blockDim.x
// rows walks its steps in order and restages the table where the query
// changes, scoring first the rows of the query staged before.
template <typename LutT, bool MASK>
__global__ void __launch_bounds__(kIvfThreads, kIvfMinBlocks)
ivf_adc_kernel(const LutT* __restrict__ lut, const float* __restrict__ scales,
               const uint8_t* __restrict__ codes,
               const int32_t* __restrict__ block_idx,
               const int32_t* __restrict__ block_query,
               const int32_t* __restrict__ ids, float* __restrict__ out,
               long long S, int Dp, int K, int bs, int run,
               int runs_per_query, long long spq, bool vec16) {
  extern __shared__ float4 smem4[];
  float* lut_s = reinterpret_cast<float*>(smem4);
  int* tile_s = reinterpret_cast<int*>(lut_s + Dp * K);
  int* query_s = tile_s + kIvfWindow;
  long long s0, s1;
  if (spq > 0) {
    const long long q = blockIdx.x / runs_per_query;
    s0 = q * spq + static_cast<long long>(blockIdx.x % runs_per_query) * run;
    s1 = min(s0 + run, (q + 1) * spq);
  } else {
    s0 = static_cast<long long>(blockIdx.x) * run;
    s1 = min(S, s0 + run);
  }
  int cur_q = -1;
  for (long long w0 = s0; w0 < s1; w0 += kIvfWindow) {
    const int steps =
        static_cast<int>(min(static_cast<long long>(kIvfWindow), s1 - w0));
    const int q0 = __ldg(block_query + w0);
    bool one = true;
    __syncthreads();  // the last window's steps are read
    for (int i = threadIdx.x; i < steps; i += blockDim.x) {
      tile_s[i] = __ldg(block_idx + w0 + i);
      query_s[i] = __ldg(block_query + w0 + i);
      one = one && query_s[i] == q0;
    }
    one = __syncthreads_and(one);
    float* o = out + w0 * bs;
    const int nrows = steps * bs;
    if (one) {
      if (q0 != cur_q) {
        stage_tables<LutT, 1>(lut_s, lut, scales, q0, 1, Dp * K, K);
        __syncthreads();
        cur_q = q0;
      }
      for (int f = threadIdx.x; f < nrows; f += blockDim.x) {
        const int i = f / bs, r = f - i * bs;
        const long long row = static_cast<long long>(tile_s[i]) * bs + r;
        const RowHead h = read_head<MASK>(codes, ids, row, Dp, vec16);
        ivf_row<MASK>(o + static_cast<long long>(i) * bs, lut_s, h, codes,
                      row, r, Dp, K, vec16);
      }
      continue;
    }
    for (int f0 = 0; f0 < nrows; f0 += blockDim.x) {
      const int f = f0 + threadIdx.x;
      const bool mine = f < nrows;
      const int i = (mine ? f : f0) / bs, r = f - i * bs;
      const int my_q = query_s[i];
      const long long row = static_cast<long long>(tile_s[i]) * bs + r;
      RowHead h{};
      if (mine) h = read_head<MASK>(codes, ids, row, Dp, vec16);
      bool done = !mine;
      const int i_last =
          (min(f0 + static_cast<int>(blockDim.x), nrows) - 1) / bs;
      for (int t = f0 / bs; t <= i_last; ++t) {
        const int q = query_s[t];  // the same for all threads
        if (q != cur_q) {
          if (!done && my_q == cur_q) {
            ivf_row<MASK>(o + static_cast<long long>(i) * bs, lut_s, h,
                          codes, row, r, Dp, K, vec16);
            done = true;
          }
          __syncthreads();
          stage_tables<LutT, 1>(lut_s, lut, scales, q, 1, Dp * K, K);
          __syncthreads();
          cur_q = q;
        }
      }
      if (!done && my_q == cur_q)
        ivf_row<MASK>(o + static_cast<long long>(i) * bs, lut_s, h, codes,
                      row, r, Dp, K, vec16);
    }
  }
}

// out[q, row] for the chunk of RC queries q0 = c * RC .. and the rows
// [rb * rows_per_block, +rows_per_block), block x = rb * chunks + c: the
// chunks of a row range run side by side and share its codes in L2. Each
// thread reads a code row once (its id with it) and scores it against
// every staged query.
template <typename LutT, bool MASK, int RC>
__global__ void __launch_bounds__(kFlatMaxThreads)
adc_lookup_kernel(const LutT* __restrict__ lut,
                  const float* __restrict__ scales,
                  const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ ids, float* __restrict__ out,
                  int b, long long N, int Dp, int K, int rows_per_block,
                  bool vec16) {
  extern __shared__ float4 smem4[];
  float* lut_s = reinterpret_cast<float*>(smem4);
  const int chunks = (b + RC - 1) / RC;
  const long long q0 = static_cast<long long>(blockIdx.x % chunks) * RC;
  const int tables = min(RC, static_cast<int>(b - q0));
  stage_tables<LutT, RC>(lut_s, lut, scales, q0, tables, Dp * K, K);
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x / chunks) *
                       rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  float* o = out + q0 * N;
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const RowHead h = read_head<MASK>(codes, ids, row, Dp, vec16);
    float acc[RC];
    if (MASK && h.id < 0) {
#pragma unroll
      for (int t = 0; t < RC; ++t) acc[t] = -INFINITY;
    } else {
      score_row<RC>(acc, lut_s, h, codes + row * Dp, Dp, K, vec16);
    }
#pragma unroll
    for (int t = 0; t < RC; ++t) {
      if (t < tables) o[t * N + row] = acc[t];
    }
  }
}

// -- the grouped scan --------------------------------------------------------

// A chunk of T tables as planes: T / 4 of four tables (float4), then one of
// two (float2) and one of one where T leaves them. Plane p of width w holds
// the chunk's tables from first(p) on, at lut_s + first(p) * DK.
template <int T>
struct Planes {
  static constexpr int p4 = T / 4, p2 = (T % 4) / 2, p1 = T % 2;
};

// Stage the chunk's first `tables` (<= T) tables, from table q0 on, as its
// planes; a slot past `tables` in a plane holds zeros, a plane with no
// table is not staged (its sums are never stored).
template <typename LutT, int T>
__device__ __forceinline__ void stage_planes(float* lut_s, const LutT* lut,
                                             const float* scales,
                                             long long q0, int tables,
                                             int DK, int K) {
  using P = Planes<T>;
#pragma unroll
  for (int p = 0; p < P::p4; ++p) {
    if (4 * p < tables)
      stage_tables<LutT, 4>(lut_s + 4 * p * DK, lut, scales, q0 + 4 * p,
                            tables - 4 * p, DK, K);
  }
  constexpr int t2 = 4 * P::p4, t1 = 4 * P::p4 + 2 * P::p2;
  if constexpr (P::p2 > 0) {
    if (t2 < tables)
      stage_tables<LutT, 2>(lut_s + t2 * DK, lut, scales, q0 + t2,
                            tables - t2, DK, K);
  }
  if constexpr (P::p1 > 0) {
    if (t1 < tables)
      stage_tables<LutT, 1>(lut_s + t1 * DK, lut, scales, q0 + t1, 1, DK, K);
  }
}

// acc[t] += entry `at` of each of the chunk's T staged tables: one wide
// shared load a plane.
template <int T>
__device__ __forceinline__ void add_planes(float (&acc)[T],
                                           const float* lut_s, int at,
                                           int DK) {
  using P = Planes<T>;
#pragma unroll
  for (int p = 0; p < P::p4; ++p)
    add_entry<4>(acc + 4 * p, lut_s + 4 * p * DK, at);
  constexpr int t2 = 4 * P::p4, t1 = 4 * P::p4 + 2 * P::p2;
  if constexpr (P::p2 > 0) add_entry<2>(acc + t2, lut_s + t2 * DK, at);
  if constexpr (P::p1 > 0) add_entry<1>(acc + t1, lut_s + t1 * DK, at);
}

// The lookups of one code word of 4 * N bytes (columns d0 ..), in order.
template <int T, int N>
__device__ __forceinline__ void add_words(float (&acc)[T],
                                          const float* lut_s,
                                          const uint32_t (&words)[N], int d0,
                                          int K, int DK) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      add_planes<T>(acc, lut_s,
                    (d0 + 4 * j + b) * K + ((words[j] >> (8 * b)) & 0xffu),
                    DK);
  }
}

// Score one code row against the chunk's T tables: acc[t] is table t's sum
// of the row's Dp lookups, float32 from 0, columns in ascending order. The
// row is read by 16-byte loads (vec 16), 8-byte loads (vec 8) or bytes.
template <int T>
__device__ __forceinline__ void score_planes(float (&acc)[T],
                                             const float* lut_s,
                                             const uint8_t* row, int Dp,
                                             int K, int DK, int vec) {
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.f;
  if (vec == 16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < Dp / 16; ++c) {
      const uint4 w = __ldg(p + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      add_words<T, 4>(acc, lut_s, words, 16 * c, K, DK);
    }
  } else if (vec == 8) {
    const uint2* p = reinterpret_cast<const uint2*>(row);
    for (int c = 0; c < Dp / 8; ++c) {
      const uint2 w = __ldg(p + c);
      const uint32_t words[2] = {w.x, w.y};
      add_words<T, 2>(acc, lut_s, words, 8 * c, K, DK);
    }
  } else {
    for (int d = 0; d < Dp; ++d)
      add_planes<T>(acc, lut_s, d * K + __ldg(row + d), DK);
  }
}

// out[gi, j, s] for group gi = blockIdx.y, the chunk of T tables
// j in [j0, j0 + T) with j0 = (blockIdx.x % chunks) * T (the last chunk
// may hold fewer), and the rows s in [run * rows_per_block,
// +rows_per_block) with run = blockIdx.x / chunks. Each thread reads a code
// row once and scores it against every table of the chunk.
template <typename LutT, int T>
__global__ void __launch_bounds__(
    kMaxBatchThreads,
    std::is_same<LutT, float>::value && T <= kBatchWideTables ? 2 : 1)
adc_batch_kernel(const LutT* __restrict__ lut,
                 const float* __restrict__ scales,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int r, long long S, int Dp, int K, int chunks,
                 int rows_per_block, int vec) {
  extern __shared__ float4 smem4[];
  float* lut_s = reinterpret_cast<float*>(smem4);
  const int DK = Dp * K;
  const long long gi = blockIdx.y;
  const int j0 = static_cast<int>(blockIdx.x % chunks) * T;
  const int tables = min(T, r - j0);
  stage_planes<LutT, T>(lut_s, lut, scales, gi * r + j0, tables, DK, K);
  __syncthreads();
  const long long s0 =
      static_cast<long long>(blockIdx.x / chunks) * rows_per_block;
  const long long s1 = min(S, s0 + rows_per_block);
  const uint8_t* rows = codes + gi * S * Dp;
  float* o = out + (gi * r + j0) * S;
  for (long long s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    float acc[T];
    score_planes<T>(acc, lut_s, rows + s * Dp, Dp, K, DK, vec);
#pragma unroll
    for (int t = 0; t < T; ++t) {
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

// 16 where a code row is whole 16-byte words and the codes are 16-byte
// aligned, 8 for 8-byte words, else 1 (byte loads).
int row_vec(const void* codes, int Dp) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  if (Dp % 16 == 0 && at % 16 == 0) return 16;
  if (Dp % 8 == 0 && at % 8 == 0) return 8;
  return 1;
}

// The launch plans are kernels/ops.py's (ivf_adc_plan, adc_lookup_plan);
// the launchers only check that a plan is whole before they launch it.
template <typename LutT, bool MASK>
cudaError_t launch_ivf(const void* lut, const void* scales, const void* codes,
                       const void* block_idx, const void* block_query,
                       const void* ids, void* out, long long S, int Dp, int K,
                       int bs, int run, int runs_per_query, long long spq,
                       long long blocks, int threads, size_t smem,
                       cudaStream_t stream) {
  const bool aligned =
      spq > 0 && S % spq == 0 && runs_per_query > 0 &&
      blocks == S / spq * runs_per_query &&
      static_cast<long long>(run) * runs_per_query >= spq &&
      static_cast<long long>(run) * (runs_per_query - 1) < spq;
  const bool plain = spq == 0 && blocks == (S + run - 1) / run;
  if (threads != kIvfThreads || run < 1 || !(aligned || plain) ||
      blocks > 0x7fffffffLL ||
      static_cast<long long>(kIvfWindow) * bs > 0x7fffffffLL ||
      smem != sizeof(float) * static_cast<size_t>(Dp) * K +
                  2 * sizeof(int) * kIvfWindow)
    return cudaErrorInvalidValue;
  auto kernel = ivf_adc_kernel<LutT, MASK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(block_idx),
      static_cast<const int32_t*>(block_query),
      static_cast<const int32_t*>(ids), static_cast<float*>(out), S, Dp, K,
      bs, run, runs_per_query, spq, row_vec(codes, Dp) == 16);
  return cudaGetLastError();
}

template <typename LutT, bool MASK, int RC>
cudaError_t launch_flat(const void* lut, const void* scales, const void* codes,
                        const void* ids, void* out, int b, long long N, int Dp,
                        int K, int rows_per_block, long long blocks,
                        int threads, size_t smem, cudaStream_t stream) {
  const long long chunks = (b + RC - 1) / RC;
  if (threads < 32 || threads > kFlatMaxThreads || rows_per_block < 1 ||
      blocks != chunks * ((N + rows_per_block - 1) / rows_per_block) ||
      blocks > 0x7fffffffLL ||
      smem != sizeof(float) * RC * static_cast<size_t>(Dp) * K)
    return cudaErrorInvalidValue;
  auto kernel = adc_lookup_kernel<LutT, MASK, RC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), b, N, Dp, K, rows_per_block,
      row_vec(codes, Dp) == 16);
  return cudaGetLastError();
}

template <typename LutT, bool MASK>
cudaError_t launch_flat_tables(const void* lut, const void* scales,
                               const void* codes, const void* ids, void* out,
                               int b, long long N, int Dp, int K, int rc,
                               int rows_per_block, long long blocks,
                               int threads, size_t smem,
                               cudaStream_t stream) {
#define REPRO_FLAT_RC(RC)                                                  \
  launch_flat<LutT, MASK, RC>(lut, scales, codes, ids, out, b, N, Dp, K, \
                              rows_per_block, blocks, threads, smem, stream)
  switch (rc) {
    case 1: return REPRO_FLAT_RC(1);
    case 2: return REPRO_FLAT_RC(2);
    case 4: return REPRO_FLAT_RC(4);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLAT_RC
}

template <typename LutT, int T>
cudaError_t launch_batch(const void* lut, const void* scales,
                         const void* codes, void* out, int g, int r,
                         long long S, int Dp, int K, int chunks,
                         int rows_per_block, long long blocks, int threads,
                         size_t smem, cudaStream_t stream) {
  auto kernel = adc_batch_kernel<LutT, T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(g));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const LutT*>(lut), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(codes), static_cast<float*>(out), r, S, Dp,
      K, chunks, rows_per_block, row_vec(codes, Dp));
  return cudaGetLastError();
}

// The plan is kernels/ops.py adc_batch_plan's; it is checked whole here:
// the chunks cover the r tables once, the row runs the S rows, the staged
// tables are the shared memory asked for, and the grid is within limits.
template <typename LutT>
cudaError_t launch_batch_tables(const void* lut, const void* scales,
                                const void* codes, void* out, int g, int r,
                                long long S, int Dp, int K, int chunk,
                                int chunks, int rows_per_block,
                                long long blocks, int threads,
                                size_t smem, cudaStream_t stream) {
  if (chunk < 1 || chunk > kBatchMaxTables || chunks < 1 ||
      static_cast<long long>(chunk) * chunks < r ||
      static_cast<long long>(chunk) * (chunks - 1) >= r ||
      threads < 32 || threads > kMaxBatchThreads || threads % 32 != 0 ||
      rows_per_block < 1 ||
      blocks != chunks * ((S + rows_per_block - 1) / rows_per_block) ||
      blocks > 0x7fffffffLL || g < 1 || g > 65535 ||
      smem != sizeof(float) * static_cast<size_t>(chunk) * Dp * K)
    return cudaErrorInvalidValue;
#define REPRO_BATCH(T)                                                      \
  case T:                                                                   \
    return launch_batch<LutT, T>(lut, scales, codes, out, g, r, S, Dp, K,  \
                                 chunks, rows_per_block, blocks, threads,  \
                                 smem, stream);
  switch (chunk) {
    REPRO_BATCH(1) REPRO_BATCH(2) REPRO_BATCH(3) REPRO_BATCH(4)
    REPRO_BATCH(5) REPRO_BATCH(6) REPRO_BATCH(7) REPRO_BATCH(8)
    REPRO_BATCH(9) REPRO_BATCH(10) REPRO_BATCH(11) REPRO_BATCH(12)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BATCH
}

}  // namespace

// lut_kind: 0 = float32, 1 = int8 (+ scales), 2 = uint8 (+ scales).
// ids == nullptr selects the unmasked body. The plan's numbers are
// kernels/ops.py ivf_adc_plan's. Returns a cudaError_t.
extern "C" int repro_ivf_adc(const void* lut, int lut_kind, const void* scales,
                             const void* codes, const void* block_idx,
                             const void* block_query, const void* ids,
                             void* out, long long S, int Dp, int K, int bs,
                             int run, int runs_per_query, long long spq,
                             long long blocks, int threads, long long smem,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = ids != nullptr;
#define REPRO_IVF(T, M)                                                   \
  launch_ivf<T, M>(lut, scales, codes, block_idx, block_query, ids, out, \
                   S, Dp, K, bs, run, runs_per_query, spq, blocks,       \
                   threads, static_cast<size_t>(smem), st)
  switch (lut_kind) {
    case 0: return m ? REPRO_IVF(float, true) : REPRO_IVF(float, false);
    case 1: return m ? REPRO_IVF(int8_t, true) : REPRO_IVF(int8_t, false);
    case 2: return m ? REPRO_IVF(uint8_t, true) : REPRO_IVF(uint8_t, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_IVF
}

// rc queries' tables a block (1, 2 or 4, interleaved), blocks of `threads`
// threads over `rows_per_block` rows: kernels/ops.py adc_lookup_plan's.
extern "C" int repro_adc_lookup(const void* lut, int lut_kind,
                                const void* scales, const void* codes,
                                const void* ids, void* out, int b, long long N,
                                int Dp, int K, int rc, int rows_per_block,
                                long long blocks, int threads, long long smem,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = ids != nullptr;
#define REPRO_FLAT(T, M)                                                  \
  launch_flat_tables<T, M>(lut, scales, codes, ids, out, b, N, Dp, K, rc, \
                           rows_per_block, blocks, threads,               \
                           static_cast<size_t>(smem), st)
  switch (lut_kind) {
    case 0: return m ? REPRO_FLAT(float, true) : REPRO_FLAT(float, false);
    case 1: return m ? REPRO_FLAT(int8_t, true) : REPRO_FLAT(int8_t, false);
    case 2: return m ? REPRO_FLAT(uint8_t, true) : REPRO_FLAT(uint8_t, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLAT
}

// out (g, r, S) float32: kernels/ops.py adc_batch_plan's chunk tables of
// a group a block (at most kBatchMaxTables, staged as planes), `chunks` of
// them, blocks of `threads` threads over `rows_per_block` rows, `blocks`
// blocks of chunks × row runs for each of the g groups, `smem` bytes of
// tables. Returns a cudaError_t.
extern "C" int repro_adc_batch(const void* lut, int lut_kind,
                               const void* scales, const void* codes,
                               void* out, int g, int r, long long S, int Dp,
                               int K, int chunk, int chunks,
                               int rows_per_block, long long blocks,
                               int threads, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TABLES(T)                                                     \
  launch_batch_tables<T>(lut, scales, codes, out, g, r, S, Dp, K, chunk,   \
                         chunks, rows_per_block, blocks, threads,          \
                         static_cast<size_t>(smem), st)
  switch (lut_kind) {
    case 0: return REPRO_TABLES(float);
    case 1: return REPRO_TABLES(int8_t);
    case 2: return REPRO_TABLES(uint8_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TABLES
}
