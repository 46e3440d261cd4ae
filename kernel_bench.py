#!/usr/bin/env python3
"""Time the port's kernels of any checkout on one GPU.

Run from the repository root:

    python3 kernel_bench.py [--src DIR] [--only NAME ...]
    python3 kernel_bench.py --split [--only NAME ...]
    python3 kernel_bench.py --sweep

Times each kernel as ``chip_smoke.py`` does (device time per launch from a
CUDA graph of back-to-back launches) beside its plain version and its bound
(bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s), on seeded
operands at the smoke's shapes:

  * ``gcd_score`` at the serving width, the training width and
    ``chip_smoke.GCD_RAGGED``, with the one ``torch.matmul`` that computes
    the same field;
  * ``pq_assign`` at every entry of ``chip_smoke.ASSIGN_SHAPES``;
  * ``ivf_adc`` at every entry of ``chip_smoke.ivf_cases()`` (serve_p99
    and the Engine's buckets, nprobe 32) over the smoke's serving index (N
    sift_like rows, the identity rotation in place of main's GCD steps),
    masked as the search path calls it, with float32 tables (and their
    ``embedding_bag`` yardstick) and with int8 tables, as the Engine's int8
    requests send them;
  * ``adc_lookup`` at every entry of ``chip_smoke.flat_cases()`` (the flat
    check over that index, masked; the train eval's (256, 64, 256) tables
    over 1,541,673 random codes, unmasked), with the smoke's
    ``flat_library`` yardstick (one ``F.embedding_bag``, unmasked);
  * ``adc_batch`` at ``BATCH_SHAPES``: olmo-1b's and qwen1.5-4b's decode
    (g = 16 and 20, r = 1, Dp = 16, S = 524,288), grok-1's and
    llama4-maverick's (g = 8, r = 6 and 5), and nemotron-4's geometry (g =
    8, r = 12, Dp = 24) at the smoke's S = 65,537 and at 524,288, on
    random codes, with the smoke's ``F.embedding_bag`` yardstick, its launch
    plan, its lookups and the shared-gather floor of its planes and of r
    4-byte lookups a code byte (the design before planes);
  * ``fused_lut`` at ``chip_smoke.ivf_cases()``' batches (serve_p99 and
    the Engine's buckets) at the serving width (n = 256, Dp = 32,
    K = 256, sub = 8), with the two library calls that compute the same
    tables (``torch.matmul`` by qdelta, then ``torch.bmm`` over the
    subspaces);
  * ``givens_rotate`` at every entry of ``chip_smoke.rotate_cases()``
    (training's R, the serving refresh's R, centroids and codebook rows,
    the backward's batch) with n / 2 pairs, with one ``torch.matmul`` by
    the dense rotation.

Each scan row also prints its schedule (S, max_blocks, live rows), the
table loads and lookups of one launch, and its shared-gather floor: the
shared-memory wavefronts its lookups need on these codes (per warp and
column, the most distinct entries any bank, or 16-byte bank group for a
float4 table of four queries, must serve) over the SMs at their highest
clock. ``chip_smoke.py`` holds every kernel to its plain version at these
shapes; this script only times them, so that two checkouts can be timed
at the same shapes in one call.

``--src`` imports ``repro_torch`` from another checkout's ``src/`` (a
``git archive`` of an earlier commit, say), whose kernels its own
``_build`` compiles into that checkout, and times them; the launch-plan
columns of the scan rows (blocks, table loads) describe this checkout's
plan and are left out. For parent against change on one card, run parent,
change, change, parent in one call.

``--split`` times where a kernel's time goes instead, on copies of its
source edited by ``SPLITS`` and built by ``nvcc`` with the port's flags
into ``build/kernel_bench/``: ``gcd_score`` at n = 256 and 512 with the
FMAs taken out (the copies alone) and with every copy after the first ring
stage taken out (the contraction alone, on stale data); the scans
(``ivf_adc`` at serve_p99 and bucket 8, ``adc_lookup`` at the flat check)
with only the table loads left, with the lookups replaced by a sum of the
raw code bytes and no table loaded (the code and id reads alone), and with
every row's codes read from one 4,096-row window that stays in cache (the
lookups, with the table loads and id reads); ``fused_lut`` at its batches
with the table entries neither formed nor written (the rotation alone) and
with nothing staged or rotated and every entry stored as a constant (the
table write alone); ``adc_batch`` at ``BATCH_SHAPES`` with only the
planes staged (the tables alone) and with every lookup made but no score
stored (the lookups and code reads without the output store). The
``fused_lut`` edits carry a second list for the source before its
redesign, so ``--src`` splits the parent alike.

``--sweep`` times the scans, ``adc_batch``, ``fused_lut`` and
``givens_rotate`` at their cases under each setting of the launch plans'
constants in ``SWEEP`` (the other constants at their defaults), to show
what the chosen values give.
``fused_lut``'s ``_LUT_RUN_LEN`` sets the inputs per run of its rotation's
sums: it moves the order of every entry's sums (never with the batch), so
its other settings time a kernel that rounds differently, not a faster
plan of the same result.

``--kmeans`` times the smoke's serving-index build (N sift_like rows, the
identity rotation, ``chip_smoke.serve_config()``) with the k-means sums by
``index_add_``, which adds in no fixed order on the card, and by
``quant.kmeans.segment_sum``, in turns (index_add_, sorted, sorted,
index_add_), each build from one seed; it prints each build's seconds,
whether the builds of one variant have the same centroids and codebooks,
and the sums alone at the build's two k-means shapes.

One JSON line per case, then the card's ``nvidia-smi`` name and power
limit. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as smoke

#: the serving width, the training width (paper_twotower's 512) and the
#: ragged widths the smoke checks
GCD_NS = tuple(sorted({smoke.DIM, 512, *smoke.GCD_RAGGED}))
KERNELS = ("gcd_score", "pq_assign", "ivf_adc", "adc_lookup", "adc_batch",
           "fused_lut", "givens_rotate")
SPLIT_KERNELS = ("gcd_score", "ivf_adc", "adc_lookup", "adc_batch",
                 "fused_lut")
#: adc_batch (g, r, Dp, S): each LM's decode at 524,288 positions (g =
#: batch 1 × kv heads, r = heads ÷ kv heads) and chip_smoke.py's nemotron-4
#: geometry
BATCH_SHAPES = {"olmo-1b": (16, 1, 16, 524_288),
                "qwen1.5-4b": (20, 1, 16, 524_288),
                "grok-1": (8, 6, 16, 524_288),
                "llama4-maverick": (8, 5, 16, 524_288),
                "nemotron-4": (8, 12, 24, 65_537),
                "nemotron-4_524k": (8, 12, 24, 524_288)}
WINDOW = 4096                        # --split: rows of the cached window

# --split: (source, {part: edit list}); an edit (old, new) is applied to
# every occurrence of old, which must occur
_GCD_PARTS = {
    "copies_only": [("    if (active) {", "    if (active && n < 0) {")],
    "contraction_only": [("    if (s < stages) stage(s);",
                          "    if (s == 0) stage(s);"),
                         ("    if (s + S - 1 < stages) stage(s + S - 1);",
                          "")],
}
_SCAN_PARTS = {
    # no row read or scored: one entry of the staged table written a window
    # (ivf_adc) or a block (adc_lookup)
    "tables_only": [
        ("      for (int f = threadIdx.x; f < nrows; f += blockDim.x) {",
         "      if (threadIdx.x == 0) o[0] = lut_s[w0 % (Dp * K)];\n"
         "      for (int f = nrows; f < nrows; f += blockDim.x) {"),
        ("  for (long long row = r0 + threadIdx.x; row < r1; "
         "row += blockDim.x) {",
         "  if (threadIdx.x == 0) o[r0] = lut_s[r0 % (Dp * K)];\n"
         "  for (long long row = r1; row < r1; row += blockDim.x) {")],
    # no table staged, each lookup replaced by its index
    "reads_only": [
        ("  if constexpr (RC == 1) {\n    const LutT* src",
         "  return;\n  if constexpr (RC == 1) {\n    const LutT* src"),
        ("reinterpret_cast<const float4*>(lut_s)[at]",
         "make_float4(at, at, at, at)"),
        ("reinterpret_cast<const float2*>(lut_s)[at]", "make_float2(at, at)"),
        ("__fadd_rn(acc[0], lut_s[at])",
         "__fadd_rn(acc[0], static_cast<float>(at))")],
    # every row's codes from a window of WINDOW rows
    "lookups_only": [("codes + row * Dp",
                      f"codes + (row & {WINDOW - 1}) * Dp")],
}
# fused_lut: each part is a tuple of edit lists, the first whose texts all
# occur applies: this checkout's source, then the source before its
# redesign (the two-stage kernel of one code column a block), so that
# parent and change split alike
_LUT_PARTS = {
    # the rotation alone: no table entry formed or written, one entry of
    # the rotated sub-queries stored so they stay live
    "rotation_only": (
        [("  for (int e = tid; e < items * qs; e += kThreads) {",
          "  if (tid == 0) lut[b0] = q_s[0];\n"
          "  for (int e = items * qs; e < items * qs; e += kThreads) {")],
        [("  for (int k = tid; k < K; k += blockDim.x) {",
          "  if (tid == 0) lut[b0] = qr_s[0];\n"
          "  for (int k = K; k < K; k += blockDim.x) {")]),
    # the table write alone: nothing staged or rotated, every entry
    # stored as a constant by the kernel's own stores
    "write_only": (
        [("  if (vec_in) {\n    const int n4 = n / 4;",
          "  if (vec_in && n < 0) {\n    const int n4 = n / 4;"),
         ("  } else {\n    for (int e = tid; e < tile * n; e += kThreads) {",
          "  } else if (n < 0) {\n"
          "    for (int e = tid; e < tile * n; e += kThreads) {"),
         ("    for (int c = lo; c < hi; ++c) {",
          "    for (int c = hi; c < hi; ++c) {"),
         ("  for (int o = tid; o < tile * gs; o += kThreads) {",
          "  for (int o = tile * gs; o < tile * gs; o += kThreads) {"),
         ("make_float4(a[0], a[1], a[2], a[3])",
          "make_float4(1.f, 1.f, 1.f, 1.f)"),
         ("if (k + kk < k1) out[kk] = a[kk];",
          "if (k + kk < k1) out[kk] = 1.f;")],
        [("  for (int e = tid; e < n * SUB; e += blockDim.x) {",
          "  for (int e = n * SUB; e < n * SUB; e += blockDim.x) {"),
         ("    if (i < rows) {", "    if (i < 0) {"),
         ("  for (int o = tid; o < tile * SUB; o += blockDim.x) {",
          "  for (int o = tile * SUB; o < tile * SUB; o += blockDim.x) {"),
         ("      out[static_cast<long long>(i) * Dp * K] = acc;",
          "      out[static_cast<long long>(i) * Dp * K] = 1.f;")]),
}
_BATCH_PARTS = {
    # the planes staged, no row read or scored: one staged entry written
    "tables_only": [
        ("  for (long long s = s0 + threadIdx.x; s < s1; s += blockDim.x) {",
         "  if (threadIdx.x == 0) o[s0] = lut_s[s0 % DK];\n"
         "  for (long long s = s1; s < s1; s += blockDim.x) {")],
    # every row read and looked up, no score stored (a store no sum meets)
    "no_store": [("      if (t < tables) o[t * S + s] = acc[t];",
                  "      if (t < tables && acc[t] == 1.5e38f) "
                  "o[t * S + s] = acc[t];")],
}
SPLITS = {"gcd_score": ("gcd_score.cu", _GCD_PARTS),
          "scans": ("adc_scan.cu", _SCAN_PARTS),
          "adc_batch": ("adc_scan.cu", _BATCH_PARTS),
          "fused_lut": ("fused_lut.cu", _LUT_PARTS)}
#: --sweep: each launch-plan constant of kernels/ops.py and its settings
SWEEP = {"ivf_adc": {"_IVF_WAVES": (1, 2, 4, 8),
                     "_IVF_MIN_PASSES": (1, 2, 4, 8)},
         "adc_lookup": {"_FLAT_WAVES": (2, 4, 8, 16),
                        "_FLAT_MIN_ROWS": (1, 4, 16)},
         "adc_batch": {"_BATCH_WAVES": (1, 2, 3, 4),
                       "_BATCH_THREADS": (512, 1024),
                       "_BATCH_MAX_TABLES": (4, 12)},
         "fused_lut": {"_LUT_FILL": (0.45, 0.9, 1.8),
                       "_LUT_RUN_LEN": (8, 16, 32)},
         "givens_rotate": {"_ROTATE_WAVES": (1, 2, 4),
                           "_ROTATE_RUN_BYTES": (4096, 8192, 32_768)}}


def _gcd_operands(g, n: int):
    import torch

    G = torch.randn((n, n), generator=g, device=g.device)
    R = torch.linalg.qr(torch.randn((n, n), generator=g, device=g.device))[0]
    return G, R.contiguous()


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def time_gcd(g, n: int) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    G, R = _gcd_operands(g, n)
    lhs = torch.cat([G, -R], dim=0).T.contiguous()
    rhs = torch.cat([R, G], dim=0).contiguous()
    flops, nbytes = 2 * n ** 3 + n * n, 3 * n * n * 4
    _emit(kernel="gcd_score", n=n,
          ms=smoke.graph_ms(lambda: ops.gcd_score(G, R), launches=100),
          plain_ms=smoke.graph_ms(lambda: ref.gcd_score_ref(G, R),
                                  launches=100),
          library_ms=smoke.graph_ms(lambda: torch.matmul(lhs, rhs),
                                    launches=100),
          bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))


def time_assign(g, name: str) -> None:
    from repro_torch.kernels import ops, ref

    m, D, K, sub = smoke.ASSIGN_SHAPES[name]
    X, C = smoke.assign_operands(g, m, D, K, sub)
    nbytes = m * D * sub * 4 + D * K * sub * 4 + m * D * 4
    flops = 2 * m * D * sub * K
    _emit(kernel="pq_assign", case=name, m=m, D=D, K=K, sub=sub,
          ms=smoke.graph_ms(lambda: ops.pq_assign(X, C),
                            launches=5 if flops > 2e10 else 20),
          plain_ms=smoke.graph_ms(lambda: ref.pq_assign_ref(X, C),
                                  launches=2),
          bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))


# -- the scans ---------------------------------------------------------------


def _sm_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


def gather_wavefronts(codes, active, lanes: int, units: int):
    """Shared-memory wavefronts of the table lookups of ``codes`` (W, 32,
    Dp) uint8, one warp of 32 rows per entry, a column at a time, summed
    over the columns -> (W,) int64: each phase of ``lanes`` lanes costs
    the most distinct codes that fall in one of ``units`` bank units (code
    mod ``units``); inactive lanes read nothing. 4-byte entries: lanes 32,
    units 32; float2 entries (two queries interleaved): 16 and 16; float4
    (four): 8 and 8."""
    import torch

    out = []
    for lo in range(0, codes.shape[0], 2048):
        c = codes[lo:lo + 2048].long()
        W, _, Dp = c.shape
        c = torch.where(active[lo:lo + 2048, :, None], c,
                        torch.full_like(c, 256))
        # (W, phases, Dp, lanes) -> presence of each of the 256 codes
        c = c.view(W, 32 // lanes, lanes, Dp).transpose(2, 3)
        seen = torch.zeros((*c.shape[:3], 257), dtype=torch.int32,
                           device=c.device)
        seen.scatter_(3, c, 1)
        distinct = seen[..., :256].reshape(*c.shape[:3], 256 // units,
                                           units).sum(3)
        out.append(distinct.amax(3).sum((1, 2)))
    return torch.cat(out)


def _serving(g):
    """The smoke's serving index over N sift_like rows (the identity
    rotation) and the largest case's queries."""
    import torch

    from repro_torch import search
    from repro_torch.data import synthetic

    nq = max(smoke.ivf_cases().values())
    allx = synthetic.sift_like(g, smoke.N + nq, smoke.DIM)
    R = torch.eye(smoke.DIM, device=allx.device)
    state = search.make("ivf").build(g, allx[:smoke.N], R,
                                     smoke.serve_config())
    return state.index, allx[smoke.N:]


def ivf_operands(index, Q, names=None):
    """(name, b, max_blocks, block_idx, block_query, float32 tables) of
    chip_smoke.ivf_cases() over the serving index."""
    from repro_torch.index import search as index_search

    mb = index.max_list_blocks()
    for name, b in smoke.ivf_cases().items():
        if names is not None and name not in names:
            continue
        QR = Q[:b] @ index.R
        sched = index_search.scan_schedule(
            index, QR, nprobe=smoke.SERVE_NPROBE, max_blocks=mb)
        lut = index_search.build_luts(index.quantizer, QR)
        yield name, b, mb, sched.block_idx, sched.block_query, lut


def _ivf_plan_stats(index, bi, bq, b: int, Dp: int, K: int,
                    clock_hz: float) -> dict:
    """Blocks and table loads of one launch under this checkout's plan, and
    the lookups' shared-gather floor on the index's codes."""
    import torch

    from repro_torch.kernels import ops

    codes, ids, bs = index.codes, index.ids, smoke.BS
    S, sms = bi.numel(), ops._sms(codes.device)
    plan = ops.ivf_adc_plan(S, b, bs, Dp, K, sms)
    starts = ops.ivf_adc_run_starts(plan, S, device=bi.device)
    first = torch.zeros(S, dtype=torch.bool, device=bi.device)
    first[starts] = True
    first[1:] |= bq[1:] != bq[:-1]
    # each distinct tile's wavefronts, times the steps that scan it
    tiles = codes.view(-1, bs // 32, 32, Dp)
    live = (ids >= 0).view(-1, bs // 32, 32)
    uniq, mult = torch.unique(bi.long(), return_counts=True)
    per_tile = gather_wavefronts(
        tiles[uniq].reshape(-1, 32, Dp), live[uniq].reshape(-1, 32),
        32, 32).view(uniq.numel(), -1).sum(1)
    wf = int((per_tile * mult).sum())
    return dict(blocks=int(starts.numel()), table_loads=int(first.sum()),
                wavefronts=wf, gather_floor_ms=wf / (sms * clock_hz) * 1e3)


def time_ivf(index, Q, clock_hz: float, plan_stats: bool) -> None:
    """ivf_adc at each case with float32 and with int8 tables."""
    from repro_torch.kernels import ops, ref

    codes, ids, bs = index.codes, index.ids, smoke.BS
    for name, b, mb, bi, bq, lut in ivf_operands(index, Q):
        S, (_, Dp, K) = bi.numel(), lut.shape
        case = dict(case=name, b=b, nprobe=smoke.SERVE_NPROBE,
                    max_blocks=mb, S=S)
        if plan_stats:
            case.update(_ivf_plan_stats(index, bi, bq, b, Dp, K, clock_hz))
        for dt, (tab, scales) in (("float32", (lut, None)),
                                  ("int8", ops.quantize_luts(lut, "int8"))):
            work = smoke.ivf_work(tab, scales, codes, ids, bi, bs)
            row = dict(kernel="ivf_adc", lut=dt, **case,
                       lookups=work["flops"], live_rows=work["live_rows"],
                       unique_tiles=work["unique_tiles"],
                       ms=smoke.graph_ms(lambda: ops.ivf_adc(
                           tab, codes, bi, bq, scales, ids, block_size=bs),
                           launches=20),
                       plain_ms=smoke.graph_ms(lambda: ref.ivf_adc_ref(
                           tab, codes, bi, bq, block_size=bs, scales=scales,
                           ids=ids), launches=2),
                       bytes=work["bytes"], flops=work["flops"],
                       bound_ms=work["bound_ms"], bound_by=work["bound_by"])
            if scales is None:
                lib = smoke.ivf_library(tab, codes, bi, bq, bs)
                row["library_ms"] = smoke.graph_ms(lib, launches=5)
                del lib
            _emit(**row)


def flat_operands(index, Q, g):
    """(name, tables, codes, ids) of chip_smoke.flat_cases(): the flat
    check over the serving index (masked) and the train eval's random
    tables over random codes (unmasked)."""
    import torch

    from repro_torch.index import search as index_search

    for name, (b, Dp, rows) in smoke.flat_cases().items():
        if rows is None:
            lut = index_search.build_luts(index.quantizer,
                                          Q[:b] @ index.R)
            yield name, lut, index.codes, index.ids
        else:
            dev = index.codes.device
            lut = torch.randn((b, Dp, smoke.K), generator=g, device=dev)
            codes = torch.randint(0, smoke.K, (rows, Dp), generator=g,
                                  device=dev, dtype=torch.uint8)
            yield name, lut, codes, None


def time_flat(index, Q, g, clock_hz: float) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    sms = torch.cuda.get_device_properties(
        index.codes.device).multi_processor_count
    for name, lut, codes, ids in flat_operands(index, Q, g):
        (b, Dp, K), N = lut.shape, codes.shape[0]
        live = (torch.ones(N, dtype=torch.bool, device=codes.device)
                if ids is None else ids >= 0)
        whole = N // 32 * 32
        warps = codes[:whole].view(-1, 32, Dp)
        act = live[:whole].view(-1, 32)
        # 4-byte tables, one query a pass; float4 of four queries; float2
        floors = {f"gather_floor_{kind}_ms": passes * int(gather_wavefronts(
            warps, act, lanes, lanes).sum()) / (sms * clock_hz) * 1e3
            for kind, passes, lanes in (("scalar", b, 32),
                                        ("float4", -(-b // 4), 8),
                                        ("float2", -(-b // 2), 16))}
        n_live = int(live.sum())
        nbytes = (lut.numel() * 4 + (0 if ids is None else N * 4)
                  + n_live * Dp + b * N * 4)
        flops = b * n_live * Dp
        lib = smoke.flat_library(lut, codes)
        _emit(kernel="adc_lookup", case=name, b=b, Dp=Dp, K=K, N=N,
              masked=ids is not None, live_rows=n_live, lookups=flops,
              **floors,
              ms=smoke.graph_ms(lambda: ops.adc_lookup(lut, codes, None,
                                                       ids), launches=5),
              plain_ms=smoke.graph_ms(lambda: ref.adc_lookup_ref(
                  lut, codes, None, ids), launches=1),
              library_ms=smoke.graph_ms(lib, launches=2),
              bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))
        del codes, lib


def batch_operands(g, names=None):
    """(name, random (g, r, Dp, K) tables, random (g, S, Dp) uint8 codes) at
    each of BATCH_SHAPES."""
    import torch

    for name, (G, r, Dp, S) in BATCH_SHAPES.items():
        if names is None or name in names:
            yield (name,
                   torch.randn((G, r, Dp, smoke.K), generator=g,
                               device=g.device),
                   torch.randint(0, smoke.K, (G, S, Dp), generator=g,
                                 device=g.device, dtype=torch.uint8))


def batch_floors(codes, planes, chunks: int, r: int,
                 clock_hz: float) -> dict:
    """Shared-memory wavefronts of one adc_batch launch on these codes (g,
    S, Dp), a warp of 32 rows a column at a time: the plan's planes (a
    float4 plane: phases of 8 lanes over 8 bank groups; float2: 16 over 16;
    one table: 32 over 32) for each chunk, and r 4-byte lookups (the
    design before planes); each over the SMs at their highest clock."""
    import torch

    from repro_torch.kernels import ops

    G, S, Dp = codes.shape
    whole = S // 32 * 32
    warps = codes[:, :whole].reshape(-1, 32, Dp)
    act = torch.ones(warps.shape[:2], dtype=torch.bool, device=codes.device)
    if whole < S:                     # the ragged last warp of each group
        tail = torch.zeros((G, 32, Dp), dtype=torch.uint8,
                           device=codes.device)
        tail[:, :S - whole] = codes[:, whole:]
        tact = torch.zeros((G, 32), dtype=torch.bool, device=codes.device)
        tact[:, :S - whole] = True
        warps, act = torch.cat([warps, tail]), torch.cat([act, tact])
    wf = {w: int(gather_wavefronts(warps, act, 32 // w, 32 // w).sum())
          for w in set(planes) | {1}}
    sms = ops._sms(codes.device)
    planes_wf = chunks * sum(wf[w] for w in planes)
    return dict(wavefronts=planes_wf,
                gather_floor_ms=planes_wf / (sms * clock_hz) * 1e3,
                gather_floor_scalar_ms=r * wf[1] / (sms * clock_hz) * 1e3)


def time_batch(g, clock_hz: float, plan_stats: bool) -> None:
    """adc_batch at BATCH_SHAPES beside its plain version, its bound, the
    smoke's F.embedding_bag yardstick and its shared-gather floors."""
    from repro_torch.kernels import ops

    for name, lut, codes in batch_operands(g):
        G, r, Dp, K = lut.shape
        S = codes.shape[1]
        row = dict(kernel="adc_batch", case=name, g=G, r=r, Dp=Dp, S=S,
                   lookups=G * r * S * Dp)
        if plan_stats:
            plan = ops.adc_batch_plan(G, r, S, Dp, K, ops._sms(codes.device))
            row["plan"] = plan
            row.update(batch_floors(codes, plan["planes"], plan["chunks"], r,
                                    clock_hz))
        row.update(smoke._adc_batch_row(lut, codes))
        _emit(**row)
        del lut, codes


# -- fused_lut and givens_rotate --------------------------------------------


def lut_operands(g, b: int):
    """Seeded operands of fused_lut at the serving width: b queries, an
    orthogonal qdelta, (D, K, DIM / D) codebooks, the identity column map
    and its integer form."""
    import torch

    from repro_torch.kernels import ops

    n, dev = smoke.DIM, g.device
    Q = torch.randn((b, n), generator=g, device=dev)
    qd = torch.linalg.qr(torch.randn((n, n), generator=g,
                                     device=dev))[0].contiguous()
    cb = torch.randn((smoke.D, smoke.K, n // smoke.D), generator=g,
                     device=dev)
    colmap = torch.eye(smoke.D, device=dev)
    return Q, qd, cb, colmap, ops.lut_column_map(colmap)


def lut_work(b: int, n: int, Dp: int, K: int, sub: int) -> dict:
    """Bytes (operands read once, the table written once) and float32
    operations of one fused_lut call, as chip_smoke.py counts them."""
    nbytes = 4 * (b * n + n * n + Dp * K * sub + b * Dp * K + Dp)
    flops = 2 * b * n * n + 2 * b * Dp * K * sub
    return dict(bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))


def time_lut(g, plan_stats: bool) -> None:
    """fused_lut at chip_smoke.ivf_cases()' batches (serve_p99 and the
    Engine's buckets), beside its plain version and the two library calls
    that compute the same tables."""
    import torch

    from repro_torch.kernels import ops, ref

    for name, b in smoke.ivf_cases().items():
        Q, qd, cb, colmap, cols = lut_operands(g, b)
        Dp, K, sub = cb.shape
        cbT = cb.transpose(1, 2).contiguous()

        def two_calls():
            QL = torch.matmul(Q, qd).view(b, Dp, sub).transpose(0, 1)
            return torch.bmm(QL, cbT)

        row = dict(kernel="fused_lut", case=name, b=b, n=Q.shape[1], Dp=Dp,
                   K=K, sub=sub)
        if plan_stats:
            row["plan"] = ops.fused_lut_plan(b, Q.shape[1], Dp, K, sub,
                                             ops._sms(Q.device))
        _emit(**row,
              ms=smoke.graph_ms(lambda: ops.fused_lut(Q, qd, cb, colmap,
                                                      cols=cols),
                                launches=50),
              plain_ms=smoke.graph_ms(
                  lambda: ref.fused_lut_ref(Q, qd, cb, colmap), launches=20),
              library_ms=smoke.graph_ms(two_calls, launches=20),
              **lut_work(b, Q.shape[1], Dp, K, sub))


def rotate_operands(g, m: int, n: int):
    """Seeded X (m, n) and n // 2 disjoint pairs with small angles."""
    import torch

    dev = g.device
    X = torch.randn((m, n), generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev)
    p = n // 2
    th = 0.1 * torch.randn(p, generator=g, device=dev)
    return (X, perm[:p].int().contiguous(), perm[p:2 * p].int().contiguous(),
            torch.cos(th), torch.sin(th))


def time_rotate(g, plan_stats: bool) -> None:
    """givens_rotate at every entry of chip_smoke.rotate_cases(), beside
    its plain version and one torch.matmul by the dense rotation."""
    import torch

    from repro_torch.kernels import ops, ref

    for name, (m, n) in smoke.rotate_cases().items():
        X, pi, pj, c, s = rotate_operands(g, m, n)
        delta = ref.pair_rotate_ref(torch.eye(n, device=X.device), pi, pj,
                                    c, s)
        p = pi.numel()
        nbytes, flops = 2 * m * n * 4 + 4 * p * 4, 6 * m * p
        launches = 100 if m * n <= 1 << 20 else 20
        row = dict(kernel="givens_rotate", case=name, m=m, n=n, pairs=p)
        if plan_stats:
            row["plan"] = ops.givens_rotate_plan(m, n, ops._sms(X.device))
        _emit(**row,
              ms=smoke.graph_ms(lambda: ops.givens_rotate(X, pi, pj, c, s),
                                launches=launches),
              plain_ms=smoke.graph_ms(
                  lambda: ref.pair_rotate_ref(X, pi, pj, c, s),
                  launches=launches),
              library_ms=smoke.graph_ms(lambda: torch.matmul(X, delta),
                                        launches=launches),
              bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))
        del X, delta


# -- --split -----------------------------------------------------------------


class _Swapped:
    """The kernel library with some entry points taken from another build:
    ``_build._lib`` set to this sends the wrappers' launches there."""

    def __init__(self, base, variant, names):
        self._base, self._variant, self._names = base, variant, names

    def __getattr__(self, name):
        return getattr(self._variant if name in self._names else self._base,
                       name)


def _variant(source: str, part: str, edits) -> ctypes.CDLL:
    """Build a copy of csrc/``source`` edited by ``edits``: an edit list,
    or a tuple of them of which the first whose texts all occur applies."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "kernel_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / source).read_text()
    options = edits if isinstance(edits, tuple) else (edits,)
    edits = next((opt for opt in options
                  if all(old in text for old, _ in opt)), options[0])
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"--split {part}: {old!r} is not in {source}")
        text = text.replace(old, new)
    stem = f"{Path(source).stem}_{part}"
    (out_dir / f"{stem}.cu").write_text(text)
    lib = out_dir / f"lib{stem}.so"
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(lib),
                    str(out_dir / f"{stem}.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def gcd_split(g) -> None:
    """Time gcd_score beside its two halves (see the module docstring)."""
    import torch

    from repro_torch.kernels import ops

    source, parts = SPLITS["gcd_score"]
    libs = {}
    for part, edits in parts.items():
        libs[part] = _variant(source, part, edits).repro_gcd_score
        libs[part].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    for n in (256, 512):
        G, R = _gcd_operands(g, n)
        A = torch.empty_like(G)
        tile = ops.gcd_score_tile(n)
        row = dict(kernel="gcd_score", n=n, ms=smoke.graph_ms(
            lambda: ops.gcd_score(G, R), launches=100))
        for part, fn in libs.items():
            def call(fn=fn, part=part):
                smoke.check(fn(G.data_ptr(), R.data_ptr(), A.data_ptr(), n,
                               tile, torch.cuda.current_stream().cuda_stream)
                            == 0, f"gcd_score {part} launch")
            row[f"{part}_ms"] = smoke.graph_ms(call, launches=100)
        _emit(**row)


def scan_split(index, Q, g) -> None:
    """Time the two scans beside their parts (see the module docstring):
    each variant library stands in for the scans' entry points while the
    wrappers launch it, so every part runs the imported tree's own launch
    plan."""
    from repro_torch.kernels import _build, ops

    source, parts = SPLITS["scans"]
    base = _build.library()
    names = ("repro_ivf_adc", "repro_adc_lookup")
    libs = {"full": base}
    for part, edits in parts.items():
        libs[part] = _Swapped(base, _variant(source, part, edits), names)
        _build._declare(libs[part])
    cases = []
    for name, b, mb, bi, bq, lut in ivf_operands(
            index, Q, names=("serve_p99", "bucket_8")):
        cases.append((dict(kernel="ivf_adc", case=name, b=b),
                      lambda lut=lut, bi=bi, bq=bq: ops.ivf_adc(
                          lut, index.codes, bi, bq, None, index.ids,
                          block_size=smoke.BS), 20))
    for name, lut, codes, ids in flat_operands(index, Q, g):
        if name == "flat_check":
            cases.append((dict(kernel="adc_lookup", case=name,
                               b=lut.shape[0]),
                          lambda lut=lut, codes=codes, ids=ids:
                          ops.adc_lookup(lut, codes, None, ids), 5))
    try:
        for row, fn, launches in cases:
            for part, lib in libs.items():
                _build._lib = lib
                row[f"{part}_ms"] = smoke.graph_ms(fn, launches=launches)
            _emit(**row)
    finally:
        _build._lib = base


def batch_split(g) -> None:
    """Time adc_batch beside its tables alone and its lookups without the
    output store (see the module docstring) at BATCH_SHAPES."""
    from repro_torch.kernels import _build, ops

    source, parts = SPLITS["adc_batch"]
    base = _build.library()
    libs = {"full": base}
    for part, edits in parts.items():
        libs[part] = _Swapped(base, _variant(source, f"batch_{part}", edits),
                              ("repro_adc_batch",))
        _build._declare(libs[part])
    try:
        for name, lut, codes in batch_operands(g):
            row = dict(kernel="adc_batch", case=name)
            for part, lib in libs.items():
                _build._lib = lib
                row[f"{part}_ms"] = smoke.graph_ms(
                    lambda: ops.adc_batch(lut, codes), launches=20)
            _emit(**row)
    finally:
        _build._lib = base


def lut_split(g) -> None:
    """Time fused_lut beside its rotation alone and its table write alone
    (see the module docstring) at chip_smoke.ivf_cases()' batches."""
    from repro_torch.kernels import _build, ops

    source, parts = SPLITS["fused_lut"]
    base = _build.library()
    libs = {"full": base}
    for part, edits in parts.items():
        libs[part] = _Swapped(base, _variant(source, part, edits),
                              ("repro_fused_lut",))
        _build._declare(libs[part])
    try:
        for name, b in smoke.ivf_cases().items():
            Q, qd, cb, colmap, cols = lut_operands(g, b)
            row = dict(kernel="fused_lut", case=name, b=b)
            for part, lib in libs.items():
                _build._lib = lib
                row[f"{part}_ms"] = smoke.graph_ms(
                    lambda: ops.fused_lut(Q, qd, cb, colmap, cols=cols),
                    launches=50)
            _emit(**row)
    finally:
        _build._lib = base


def sweep(index, Q, g, only) -> None:
    """Time the scans at their cases under every combination of the
    settings in SWEEP of their launch plans' constants."""
    import itertools

    from repro_torch.kernels import ops

    sms = ops._sms(g.device)
    ivf = list(ivf_operands(index, Q)) if "ivf_adc" in only else []
    flat = list(flat_operands(index, Q, g)) if "adc_lookup" in only else []
    luts = ([(name, lut_operands(g, b)) for name, b in
             smoke.ivf_cases().items()] if "fused_lut" in only else [])
    rots = ([(name, rotate_operands(g, m, n)) for name, (m, n) in
             smoke.rotate_cases().items()] if "givens_rotate" in only
            else [])
    batches = list(batch_operands(g)) if "adc_batch" in only else []
    for kernel, consts in SWEEP.items():
        if kernel not in only:
            continue
        defaults = {c: getattr(ops, c) for c in consts}
        try:
            for values in itertools.product(*consts.values()):
                setting = dict(zip(consts, values))
                for c, v in setting.items():
                    setattr(ops, c, v)
                row = dict(kernel=kernel, **setting)
                if kernel == "ivf_adc":
                    codes, ids, bs = index.codes, index.ids, smoke.BS
                    for name, b, mb, bi, bq, lut in ivf:
                        row[f"{name}_ms"] = smoke.graph_ms(
                            lambda: ops.ivf_adc(lut, codes, bi, bq, None,
                                                ids, block_size=bs),
                            launches=20)
                        row[f"{name}_blocks"] = ops.ivf_adc_plan(
                            bi.numel(), b, bs, *lut.shape[1:], sms)["blocks"]
                elif kernel == "fused_lut":
                    for name, (Qb, qd, cb, colmap, cols) in luts:
                        row[f"{name}_ms"] = smoke.graph_ms(
                            lambda: ops.fused_lut(Qb, qd, cb, colmap,
                                                  cols=cols), launches=50)
                        plan = ops.fused_lut_plan(
                            Qb.shape[0], Qb.shape[1], *cb.shape, sms)
                        row[f"{name}_blocks"] = plan["blocks"]
                        row[f"{name}_runs"] = plan["runs"]
                elif kernel == "adc_batch":
                    for name, lut, cd in batches:
                        row[f"{name}_ms"] = smoke.graph_ms(
                            lambda: ops.adc_batch(lut, cd), launches=20)
                        G, r, Dp, K = lut.shape
                        plan = ops.adc_batch_plan(G, r, cd.shape[1], Dp, K,
                                                  sms)
                        row[f"{name}_chunk"] = plan["chunk"]
                        row[f"{name}_blocks"] = G * plan["blocks"]
                elif kernel == "givens_rotate":
                    for name, (X, pi, pj, c, s) in rots:
                        m, n = X.shape
                        row[f"{name}_ms"] = smoke.graph_ms(
                            lambda: ops.givens_rotate(X, pi, pj, c, s),
                            launches=100 if m * n <= 1 << 20 else 20)
                        row[f"{name}_blocks"] = ops.givens_rotate_plan(
                            m, n, sms)["blocks"]
                else:
                    for name, lut, cd, idv in flat:
                        row[f"{name}_ms"] = smoke.graph_ms(
                            lambda: ops.adc_lookup(lut, cd, None, idv),
                            launches=5)
                        b, Dp, K = lut.shape
                        row[f"{name}_blocks"] = ops.adc_lookup_plan(
                            b, cd.shape[0], Dp, K, sms)["blocks"]
                row["defaults"] = setting == defaults
                _emit(**row)
        finally:
            for c, v in defaults.items():
                setattr(ops, c, v)


def _index_add_sums(rows, seg, num_segments: int):
    """The k-means sums by ``index_add_``, in no fixed order on the card."""
    import torch

    out = torch.zeros((num_segments, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, seg, rows)


def kmeans_build(g) -> None:
    """The serving-index build with either k-means sum (see the module
    docstring)."""
    import torch

    from repro_torch import device, search
    from repro_torch.data import synthetic
    from repro_torch.quant import kmeans

    X = synthetic.sift_like(g, smoke.N, smoke.DIM)
    R = torch.eye(smoke.DIM, device=X.device)
    sums = {"index_add": _index_add_sums,
            "sorted": kmeans.segment_sum}
    keep = kmeans.segment_sum
    built = {}
    try:
        for name in ("index_add", "sorted", "sorted", "index_add"):
            kmeans.segment_sum = sums[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = search.make("ivf").build(device.generator(smoke.SEED), X,
                                             R, smoke.serve_config()).index
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            pair = (index.centroids, index.quantizer.codebooks)
            first = built.setdefault(name, pair)
            _emit(kernel="kmeans_build", sums=name, n=smoke.N,
                  train=smoke.TRAIN, seconds=seconds,
                  same_as_first=all(torch.equal(a, b)
                                    for a, b in zip(first, pair)))
            del index
    finally:
        kmeans.segment_sum = keep
    # the sums alone: the coarse fit's (TRAIN, DIM) rows in L lists and the
    # PQ fit's TRAIN · D subvectors in D · K codewords
    for what, rows, n_seg in (
            ("coarse", X[:smoke.TRAIN], smoke.L),
            ("pq", X[:smoke.TRAIN].reshape(-1, smoke.DIM // smoke.D),
             smoke.D * smoke.K)):
        seg = torch.randint(0, n_seg, (rows.shape[0],), generator=g,
                            device=X.device)
        row = dict(kernel="kmeans_sums", case=what, rows=rows.shape[0],
                   width=rows.shape[1], segments=n_seg)
        for name, fn in sums.items():
            row[f"{name}_ms"] = smoke.time_ms(
                lambda fn=fn: fn(rows, seg, n_seg), reps=10, flush=False)
        row["equal_runs"] = torch.equal(
            kmeans.segment_sum(rows, seg, n_seg),
            kmeans.segment_sum(rows, seg, n_seg))
        _emit(**row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="import repro_torch from this src/ directory")
    ap.add_argument("--split", action="store_true",
                    help="time the kernels' parts apart")
    ap.add_argument("--sweep", action="store_true",
                    help="time the scans under other launch-plan constants")
    ap.add_argument("--kmeans", action="store_true",
                    help="time the index build with either k-means sum")
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=None,
                    help="time only these kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 1
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    print(json.dumps(dict(repro_torch=ops.__file__,
                          build=_build.build_info)), flush=True)
    only = set(args.only or (SPLIT_KERNELS if args.split else
                             tuple(SWEEP) if args.sweep else KERNELS))
    g = torch.Generator(device="cuda")
    g.manual_seed(smoke.SEED + 5)
    scans = set() if args.kmeans else only & {"ivf_adc", "adc_lookup"}
    clock_hz = _sm_clock_hz()
    if scans:
        index, Q = _serving(g)
    if args.kmeans:
        kmeans_build(g)
    elif args.sweep:
        sweep(index if scans else None, Q if scans else None, g, only)
    elif args.split:
        if "gcd_score" in only:
            gcd_split(g)
        if scans:
            scan_split(index, Q, g)
        if "adc_batch" in only:
            batch_split(g)
        if "fused_lut" in only:
            lut_split(g)
    else:
        if "gcd_score" in only:
            for n in GCD_NS:
                time_gcd(g, n)
        if "pq_assign" in only:
            for name in smoke.ASSIGN_SHAPES:
                time_assign(g, name)
        if "ivf_adc" in only:
            time_ivf(index, Q, clock_hz, plan_stats=args.src is None)
        if "adc_lookup" in only:
            time_flat(index, Q, g, clock_hz)
        if "adc_batch" in only:
            time_batch(g, clock_hz, plan_stats=args.src is None)
        if "fused_lut" in only:
            time_lut(g, plan_stats=args.src is None)
        if "givens_rotate" in only:
            time_rotate(g, plan_stats=args.src is None)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
