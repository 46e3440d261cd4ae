#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each:
  env      the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the build of the CUDA kernels from csrc/;
  main     the serving slice at the two-tower-retrieval index width
           (n = 256, D = 32, K = 256, L = 1024) over N = 1,000,000 vectors:
           learn R with GCD steps, build the IVF-PQ index, serve ragged
           batches at three nprobe, check nprobe = L against the flat scan,
           take a subspace-GCD step, refresh without a rebuild, serve
           again. The kernel launch counts are set to 0 just before this
           phase and read just after it;
  kernels  every kernel of that path against its plain PyTorch version on
           the operands the main path gave it (the serve_p99 batch at
           nprobe 32, the flat-check batch, the subspace step's G and R),
           in every LUT type (float32, int8, uint8) with and without the id
           mask, plus gcd_score at a ragged n = 200; pq_assign on the
           build's encode of all N rows (coarse VQ, then PQ on the
           residuals) with its float32-tie flips counted; givens_rotate on
           the refresh's R, centroids and codebook rows, bit-equal to the
           plain version and to what the refresh stored. Times per launch
           from a CUDA graph of back-to-back launches (device time, host
           enqueue left out) for each kernel, its plain version, its
           library yardstick and the launch floor; one-shot CUDA-event
           times with a cold L2 (host latency included); then the
           serve_p99 batch stage by stage;
  engine   the serving front end on main's refreshed index: a fused-refresh
           IVF state (nprobe 32) behind search.Engine, driven by 48
           requests from SEED (sizes 512, 100, 37, 1, 300, 64 in turn,
           about half their rows repeats) with a subspace-GCD refresh after
           request 16 and a GCD-G refresh (pairs across subspaces) after
           request 32, then the stream again with int8 tables. Checked
           against direct searches, the LUT cache's hits, invalidations and
           executables, an eager refresh of the same index by the same
           deltas, recall against the exact backend, and the exact
           backends against the plain Q·Xᵀ; counts are set to 0 just
           before the path and read just after it. Then fused_lut against
           its plain version on the path's operands (b = 512 at two
           rotations, b = 1, 37, 300, a depth-2 RQ column map, n = 512),
           and its time beside the two library calls that compute the same
           tables and the eager LUT stage. The 1M-row index is freed after;
  train    the training slice at the full width of the paper's two-tower
           model (configs/paper_twotower.make_config: 1,541,673 items,
           embedding 512, towers (512, 512), history 16, D = 64, K = 256)
           by the protocol of benchmarks/fig3_table1_e2e.py: warm-up steps
           without the index layer, an OPQ warm start of (R, codebooks),
           joint steps with R moved by GCD-G, the same joint steps from the
           same warm start with R frozen, and for each the whole corpus
           encoded through the item tower and retrieved by ADC for p@50 /
           r@50. Counts are set to 0 just before and read just after, with
           the exact launches each part implies checked. Cut to fit a run:
           the step counts (10 warm-up, 20 joint), OPQ iterations (10) and
           the batch (16,384, not RECSYS_SHAPES train_batch 65,536: the
           in-batch (B, B) hinge loss is 17 GB per temporary there, and the
           JAX package has no chunked loss to port);
  train_kernels
           givens_rotate, pq_assign and embedding_bag against their plain
           versions on the operands the train phase gave them, plus ragged
           shapes (odd n with unpaired columns, the coarse-VQ shape, m not a
           multiple of the tile, weights, padding and empty bags) and the
           rotation's backward, timed like the others; adc_lookup on the
           eval retrieval's own tables (Dp = 64) over the encoded corpus,
           and gcd_score on the last GCD step's (G, R) at n = 512;
  decode   PQ-compressed KV-cache decode of olmo-1b at the full width of
           configs.get("olmo-1b").config_for_shape("long_500k") (16
           layers, d_model 2048, 16 heads of 128, KVQuantConfig(128, 16,
           256), bf16 weights from the seeded init, batch 1, a cache of
           524,288 positions). Cut to fit a run: a prompt of 4,096 seeded
           tokens is prefilled (prefilling all 524,288 is O(S²) attention);
           the KV codebooks are fitted per layer by PQ.fit on the prompt's
           K·R and V·R (R the identity init gives; the init's 0.02-scale
           codebooks would make the accuracy checks empty); positions
           4,096 … 524,279 are filled by tiling the prompt's codes and the
           length set to 524,280, so the last of 8 greedy decode tokens
           attends over every position. Counts are set to 0 just before and
           read just after, and checked against what the path implies
           (adc_batch 16 a token, pq_assign 2 a layer a prefill and a
           token, plus the fit's). Checked: compressed attention of the
           last token's last layer, over all S positions, against dense
           attention over decode_k/decode_v of the same codes (1e-4 of the
           largest entry); reported: PQ against a dense cache at the
           prompt's length (top-1 agreement, largest logit gap), per-token
           decode time, a per-layer device split by CUDA events, peak
           memory and cache bytes against a dense bf16 cache;
  decode_kernels
           adc_batch against its plain version on the decode's own operands
           (bit-equal for float32 tables, 1e-5 of the largest entry for
           int8/uint8 packs), on Nemotron's KV geometry (r = 12, Dp = 24,
           tables staged in two chunks), on Dp = 16 with r = 3 and S not a
           multiple of a block's rows, timed beside its plain version, its
           bound and one F.embedding_bag over per-group offsets.
Every check raises on failure, so the script exits non-zero with the error;
it also exits non-zero without a CUDA device. The last three lines are the
nvidia-smi line, the per-kernel JSON summary and the device JSON.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
N, DIM, D, K, L, BS = 1_000_000, 256, 32, 256, 1024, 128
TRAIN = 65536
BATCHES = (512, 100, 37)           # serve_p99 and two ragged sizes
NPROBES = (8, 32, 128)
SERVE_NPROBE = 32                  # the index's default probe width
FLAT_QUERIES = 64
EXACT_TILE = 4096                  # corpus rows per tile of the exact scan
GCD_STEPS, GCD_LR = 4, 1e-3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM float32, outside tensor cores
ATOL, RTOL = 1e-4, 1e-5            # scans: Dp float32 sums
GCD_ATOL = 1e-5
MISMATCH_LIMIT = 1e-3              # about 1e-4 seen on an H100 at N = 1M
TIE_GAP = 1e-5                     # a code flip this close is a float32 tie
SOURCES = {  # kernel: (CUDA source, the TPU kernel it replaces)
    "ivf_adc": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                "src/repro/kernels/ivf_adc.py:78"),
    "adc_lookup": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                   "src/repro/kernels/adc_lookup.py:53"),
    "gcd_score": ("src/repro_torch/kernels/csrc/gcd_score.cu",
                  "src/repro/kernels/gcd_score.py:51"),
    "givens_rotate": ("src/repro_torch/kernels/csrc/givens_rotate.cu",
                      "src/repro/kernels/givens_rotate.py:36"),
    "pq_assign": ("src/repro_torch/kernels/csrc/pq_assign.cu",
                  "src/repro/kernels/pq_assign.py:35"),
    "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag.py:44"),
    "fused_lut": ("src/repro_torch/kernels/csrc/fused_lut.cu",
                  "src/repro/kernels/lut_build.py:55"),
    "adc_batch": ("src/repro_torch/kernels/csrc/adc_scan.cu",
                  "src/repro/kernels/adc_batch.py:38"),
}
#: The kernels each path runs: the serving path's index build assigns codes
#: and its refresh rotates; the training path adds the EmbeddingBag.
SERVE_KERNELS = ("ivf_adc", "adc_lookup", "gcd_score", "pq_assign",
                 "givens_rotate")
TRAIN_KERNELS = ("gcd_score", "givens_rotate", "pq_assign", "embedding_bag",
                 "adc_lookup")
NEW_KERNELS = ("givens_rotate", "pq_assign", "embedding_bag")

# engine phase: the Engine over a fused-refresh IVF state on main's index
ENGINE_REQUESTS = 48
ENGINE_SIZES = (512, 100, 37, 1, 300, 64)
LUT_RTOL = 1e-5                    # fused_lut: of the table's max |entry|

# train phase (cut to fit a run; see the module docstring)
TRAIN_BATCH = 16_384               # RECSYS_SHAPES train_batch is 65,536
WARMUP_STEPS, JOINT_STEPS = 10, 20
OPQ_SAMPLE, OPQ_ITERS = 65_536, 10
TRAIN_LR = ROT_LR = 3e-3           # benchmarks/fig3_table1_e2e.py
SCHEDULE_WARMUP = 10
CLICK_DIM = 32                     # the click log's latent width (fig3)
EVAL_QUERIES, EVAL_K = 256, 50
TOWER_CHUNK = 262_144              # item-tower rows per call in the encode
ASSIGN_GAP = 1e-5                  # a pq_assign flip this close is a tie
BAG_RTOL = 1e-5
DTHETA_RTOL = 1e-4

# decode phase (cut to fit a run; see the module docstring)
DECODE_ARCH, DECODE_SHAPE = "olmo-1b", "long_500k"
PROMPT_LEN = 4096
DECODE_TOKENS = 8
FIT_ITERS = 10                     # k-means iterations of the codebook fit
ATTN_RTOL = 1e-4                   # compressed vs dense attention
BATCH_RTOL = 1e-5                  # adc_batch on int8/uint8 packs
SPLIT_REPS = 5                     # repetitions of the per-layer split
DECODE_KERNELS = ("adc_batch", "pq_assign")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_FLUSH = []


def time_ms(fn, reps: int, warmup: int = 2, flush: bool = True) -> float:
    """Median milliseconds of one call of ``fn`` between a CUDA-event pair,
    over ``reps`` calls, each after a 256 MiB write that evicts the 50 MB L2
    cache (unless ``flush`` is False: back-to-back serving finds it warm).
    The figure includes the host's enqueue time of the call, so it is a
    latency, not a device time, for calls shorter than tens of µs."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(1 << 26, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if flush:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn, launches: int, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    back to back in one CUDA graph, the graph replayed ``reps`` times
    between CUDA-event pairs, the median replay over ``launches``. Unlike
    one event pair around one call from Python, this leaves the host's
    enqueue cost out. The caches are warm, as for back-to-back batches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / launches
    del graph
    torch.cuda.empty_cache()
    return ms


def compare(got, want, atol: float, rtol: float) -> float:
    """Max |got − want| over finite entries; −inf positions must match."""
    import torch

    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          "−inf positions differ from the plain version")
    fin = torch.isfinite(want)
    check(bool(torch.all(torch.isfinite(got) == fin)), "non-finite output")
    err = (got[fin] - want[fin]).abs()
    ok = bool(torch.all(err <= atol + rtol * want[fin].abs()))
    max_err = float(err.max()) if err.numel() else 0.0
    check(ok, f"max abs error {max_err} beyond atol {atol} rtol {rtol}")
    return max_err


def phase_env():
    import torch

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         kernel_build_s=time.perf_counter() - t0,
         nvcc_s=_build.build_info.get("seconds"),
         ptxas=_build.build_info.get("ptxas"))
    return smi


# -- main ------------------------------------------------------------------


def _serve(searcher, state, queries, truth, flat_truth, nprobe: int,
           smi: str):
    import torch

    from repro_torch.metrics import recall_at_k

    ids, lat, scanned = [], [], []
    lo = 0
    for bsz in BATCHES:
        qb = queries[lo:lo + bsz]
        lo += bsz
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = searcher.search(state, qb, k=10, nprobe=nprobe)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(res.ids.shape == (bsz, 10) and res.scores.shape == (bsz, 10),
              "result shape")
        check(bool(torch.all(torch.isfinite(res.scores))),
              "non-finite top-10 score")
        ids.append(res.ids)
        scanned.append(res.scanned.float())
    ids = torch.cat(ids)
    return dict(nprobe=nprobe, recall_at_10=recall_at_k(ids, truth),
                recall_vs_flat_adc=recall_at_k(ids, flat_truth),
                rows_scanned_per_query=float(torch.cat(scanned).mean()),
                batch_latency_ms=dict(zip(map(str, BATCHES), lat)),
                card=smi)


def _code_flips(index, X) -> dict:
    """Rows whose stored codes differ from a float32 re-encode against
    ``index``, and for each how far apart, in float64, the stored and the
    re-encoded choice are: the largest gap between their squared
    distances, relative to the distances' scale, over the coarse list and
    every subspace. A flip at a gap of a few float32 roundings is a tie
    that rounding broke the other way, not a stale code."""
    import torch

    from repro_torch.index import ivf

    lists, codes = ivf.encode(X @ index.R, index.coarse, index.quantizer)
    rows = torch.nonzero(index.ids >= 0).squeeze(1)
    item = index.ids[rows].long()
    flip = torch.any(index.codes[rows].int() != codes[item], dim=1)
    rows, item = rows[flip], item[flip]
    out = dict(rows=int(rows.numel()), coarse_flips=0, max_rel_gap=0.0)
    if not rows.numel():
        return out
    x = X[item].double() @ index.R.double()
    C = index.centroids.double()
    ls = torch.searchsorted(index.list_offsets.long(), rows, right=True) - 1
    lr = lists[item].long()
    dc_s = ((x - C[ls]) ** 2).sum(-1)
    dc_r = ((x - C[lr]) ** 2).sum(-1)
    gaps = [(dc_s - dc_r).abs() / ((x ** 2).sum(-1) + (C[ls] ** 2).sum(-1))]
    same = ls == lr
    out["coarse_flips"] = int((~same).sum())
    if bool(same.any()):
        cb = index.codebooks.double()                     # (D, K, sub)
        r = (x[same] - C[ls[same]]).view(-1, D, DIM // D)
        d_idx = torch.arange(D, device=x.device)
        c_s = cb[d_idx, index.codes[rows[same]].long()]   # (m, D, sub)
        c_r = cb[d_idx, codes[item[same]].long()]
        ds = ((r - c_s) ** 2).sum(-1)
        dr = ((r - c_r) ** 2).sum(-1)
        scale = (r ** 2).sum(-1) + torch.maximum((c_s ** 2).sum(-1),
                                                 (c_r ** 2).sum(-1))
        gaps.append(((ds - dr).abs() / scale).amax(dim=1))
    out["max_rel_gap"] = float(torch.cat(gaps).max())
    return out


def phase_main(smi: str) -> dict:
    import torch

    from repro_torch import device, rotations, search
    from repro_torch.core import givens
    from repro_torch.data import synthetic
    from repro_torch.index import maintain
    from repro_torch.kernels import ops
    from repro_torch.quant import PQ, PQConfig

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED)
    nq = sum(BATCHES)
    allx = synthetic.sift_like(g, N + nq, DIM)
    X, Q = allx[:N], allx[N:]
    sample = X[:TRAIN]
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t_all

    # learn R: GCD-G steps on the PQ distortion gradient, PQ refit between
    t0 = time.perf_counter()
    learner = rotations.make("gcd_greedy")
    gstate = learner.init(DIM)
    trace = []
    for _ in range(GCD_STEPS):
        pq, _ = PQ.fit(g, sample @ gstate.R, PQConfig(D, K), iters=4)
        Rp = gstate.R.clone().requires_grad_(True)
        loss = pq.distortion(sample @ Rp)
        (G,) = torch.autograd.grad(loss, Rp)
        gstate, _ = learner.update(gstate, G, GCD_LR)
        trace.append(loss.item())
    R = gstate.R
    orth_learn = float(givens.orthogonality_error(R))
    check(all(v == v and v < float("inf") for v in trace),
          "distortion not finite")
    check(orth_learn < 1e-5, f"orthogonality error {orth_learn} after GCD")
    t_learn = time.perf_counter() - t0

    # build
    searcher = search.make("ivf")
    cfg = search.SearchConfig(num_lists=L, subspaces=D, codewords=K,
                              block_size=BS, nprobe=SERVE_NPROBE,
                              train_size=TRAIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = searcher.build(g, X, R, cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    st = searcher.stats(state)
    check(st["rows"] == N, "index lost rows")

    # ground truths: exact MIPS by the port's exact backend (held against
    # the plain Q·Xᵀ in phase engine), and the flat ADC scan of the codes
    exact = search.make("exact")
    exact_state = exact.build(None, X, R, search.SearchConfig(
        tile_rows=EXACT_TILE))
    truth = exact.search(exact_state, Q, k=10).ids
    flat = search.make("flat_adc")
    flat_truth = flat.search(flat.attach(state.index), Q, k=10).ids
    searcher.search(state, Q[:BATCHES[-1]], k=10)        # warm-up
    serve = [_serve(searcher, state, Q, truth, flat_truth, p, smi)
             for p in NPROBES]
    recalls = [s["recall_at_10"] for s in serve]
    check(recalls[-1] > 0.0, "zero recall")
    check(recalls[-1] >= recalls[0] - 0.01, f"recall falls with nprobe: "
          f"{recalls}")

    # nprobe = L against the flat scan over the same codes
    qf = Q[:FLAT_QUERIES]
    full = searcher.search(state, qf, k=10, nprobe=L)
    ref_res = flat.search(flat.attach(state.index), qf, k=10)
    flat_ids_equal = bool(torch.equal(full.ids, ref_res.ids))
    flat_err = float((full.scores - ref_res.scores).abs().max())
    check(flat_ids_equal, "nprobe = L ids differ from flat_adc")
    check(flat_err <= 1e-4, f"nprobe = L scores differ by {flat_err}")

    # one subspace-GCD step, refreshed into the live index, then serve
    mismatch_before = maintain.refresh_mismatch(state.index, X)
    index_before = state.index
    R_before = index_before.R
    Rp = R_before.clone().requires_grad_(True)
    loss = state.index.quantizer.distortion(sample @ Rp)
    (G_sub,) = torch.autograd.grad(loss, Rp)
    sub_learner = rotations.make("subspace_gcd", sub=DIM // D)
    _, delta = sub_learner.update(sub_learner.init_from(R_before), G_sub,
                                  GCD_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = searcher.refresh(state, delta)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    after = _serve(searcher, state, Q, truth, flat_truth, SERVE_NPROBE, smi)
    mismatch = maintain.refresh_mismatch(state.index, X)
    flips = _code_flips(state.index, X)
    orth = float(givens.orthogonality_error(state.index.R))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    emit("main", n=N, dim=DIM, subspaces=D, codewords=K, num_lists=L,
         block_size=BS, capacity=st["capacity"],
         max_blocks=st["max_blocks"], data_s=t_data, learn_s=t_learn,
         distortion_trace=trace, build_s=t_build, serve=serve,
         flat_check=dict(queries=FLAT_QUERIES, ids_equal=flat_ids_equal,
                         max_abs_score_diff=flat_err),
         refresh_s=t_refresh, after_refresh=after,
         refresh_mismatch_before=mismatch_before, refresh_mismatch=mismatch,
         refresh_code_flips=flips, theta_max=float(delta.theta.abs().max()),
         orthogonality_error=orth, launches=launches,
         peak_memory_bytes=peak, total_s=time.perf_counter() - t_all,
         card=smi, exact_truth="repro_torch search backend exact")
    check(mismatch_before == 0.0,
          f"stored codes differ from a re-encode before any refresh "
          f"({mismatch_before})")
    check(mismatch <= MISMATCH_LIMIT, f"refresh_mismatch {mismatch} after "
          "a subspace-GCD refresh")
    check(flips["max_rel_gap"] <= TIE_GAP, f"a refreshed code is stale, not "
          f"a float32 tie: {flips}")
    check(orth < 1e-5, f"orthogonality error {orth} after refresh")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    return dict(launches=launches, index=state.index, Q=Q, G=G_sub,
                R=R_before.contiguous(), X=X, index_before=index_before,
                delta=delta, peak_memory_bytes=peak, exact=exact_state,
                truth=truth, after_recall=after["recall_at_10"])


# -- kernels ----------------------------------------------------------------


def _scan_bytes(lut, scales, codes, ids, tiles, bs, out_elems, sched):
    """Bytes a scan must move: the LUT pack once, the id of every row of the
    tiles it visits and the codes of their live rows, once each, the
    schedule, and the output."""
    import torch

    rows = (tiles.long()[:, None] * bs
            + torch.arange(bs, device=tiles.device)).reshape(-1)
    live = int(torch.sum(ids[rows] >= 0))
    lut_b = lut.numel() * lut.element_size()
    if scales is not None:
        lut_b += scales.numel() * 4
    return (lut_b + rows.numel() * 4 + live * codes.shape[1]
            + sched * 4 + out_elems * 4)


def _bound(nbytes: int, flops: int) -> dict:
    """The least time on the card: the larger of bytes over the memory rate
    and float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _lut_variants(lut):
    """The float32 table and its int8/uint8 packs."""
    from repro_torch.kernels import ops

    return {"float32": (lut, None),
            **{dt: ops.quantize_luts(lut, dt) for dt in ("int8", "uint8")}}


def phase_kernels(ctx: dict) -> dict:
    """Each kernel against its plain version on the main path's operands."""
    import torch
    import torch.nn.functional as F

    from repro_torch.index import ivf
    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref

    index = ctx["index"]
    codes, ids = index.codes, index.ids
    rows, errs, one_shot = {}, {}, {}

    # ivf_adc: the serve_p99 batch at the index's default nprobe
    qb = ctx["Q"][:BATCHES[0]]
    QR = qb @ index.R
    mb = index.max_list_blocks()
    sched = index_search.scan_schedule(index, QR, nprobe=SERVE_NPROBE,
                                       max_blocks=mb)
    bi, bq = sched.block_idx, sched.block_query
    lut32 = index_search.build_luts(index.quantizer, QR)
    for dt, (lut, scales) in _lut_variants(lut32).items():
        for m in (None, ids):
            got = ops.ivf_adc(lut, codes, bi, bq, scales, m, block_size=BS)
            want = ref.ivf_adc_ref(lut, codes, bi, bq, block_size=BS,
                                   scales=scales, ids=m)
            torch.cuda.synchronize()
            errs[f"ivf_adc/{dt}/mask={m is not None}"] = compare(
                got, want, ATOL, RTOL)
            del got, want
    S = bi.numel()
    one_shot["ivf_adc"] = time_ms(lambda: ops.ivf_adc(
        lut32, codes, bi, bq, None, ids, block_size=BS), reps=30)
    k_ms = graph_ms(lambda: ops.ivf_adc(lut32, codes, bi, bq, None, ids,
                                        block_size=BS), launches=20)
    p_ms = graph_ms(lambda: ref.ivf_adc_ref(lut32, codes, bi, bq,
                                            block_size=BS, ids=ids),
                    launches=2)
    # the library yardstick: one embedding_bag over the scheduled tiles'
    # rows, each row a bag of Dp entries of the flattened (b·Dp·K) tables;
    # unmasked, and its int32 index tensor is made outside the timed call
    rows_s = (bi.long()[:, None] * BS
              + torch.arange(BS, device=bi.device)).reshape(-1)
    bag = codes[rows_s].int()                                 # (S·bs, Dp)
    bag += (torch.arange(D, device=bag.device, dtype=torch.int32) * K)
    bag += (bq.repeat_interleave(BS) * (D * K))[:, None]
    table = lut32.reshape(-1, 1)
    lib = functools.partial(F.embedding_bag, bag, table, mode="sum")
    compare(lib().view(S, BS), ref.ivf_adc_ref(lut32, codes, bi, bq,
                                               block_size=BS), ATOL, RTOL)
    lib_ms = graph_ms(lib, launches=5)
    del rows_s, bag, table, lib
    # one served batch, stage by stage, with a warm L2 as back-to-back
    # batches find it; "search" is the whole of search_prepared
    stages = {
        "rotate": lambda: qb @ index.R,
        "lut": lambda: index_search.build_luts(index.quantizer, QR),
        "schedule": lambda: index_search.scan_schedule(
            index, QR, nprobe=SERVE_NPROBE, max_blocks=mb),
        "scan": lambda: ops.ivf_adc(lut32, codes, bi, bq, None, ids,
                                    block_size=BS),
        "search": lambda: index_search.search_prepared(
            index, QR, lut32, nprobe=SERVE_NPROBE, k=10, max_blocks=mb),
    }
    stage_ms = {name: time_ms(fn, reps=20, flush=False)
                for name, fn in stages.items()}
    tiny = torch.empty(1, device=codes.device)
    launch_floor_ms = graph_ms(tiny.zero_, launches=100)
    host_launch_ms = time_ms(tiny.zero_, reps=50, flush=False)
    tiles = torch.unique(bi)
    nbytes = _scan_bytes(lut32, None, codes, ids, tiles, BS, S * BS, 2 * S)
    # one float32 add per looked-up entry of every live scored row
    flops = int(torch.sum(ids.view(-1, BS)[bi.long()] >= 0)) * D
    rows["ivf_adc"] = dict(
        shape=dict(b=qb.shape[0], nprobe=SERVE_NPROBE, max_blocks=mb, Dp=D,
                   K=K, cap=index.capacity, S=S, block_size=BS,
                   unique_tiles=int(tiles.numel())),
        ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops), library_ms=lib_ms)

    # adc_lookup: the flat-check batch over every CSR row
    QRf = ctx["Q"][:FLAT_QUERIES] @ index.R
    lutf = index_search.build_luts(index.quantizer, QRf)
    for dt, (lut, scales) in _lut_variants(lutf).items():
        for m in (None, ids):
            got = ops.adc_lookup(lut, codes, scales, m)
            want = ref.adc_lookup_ref(lut, codes, scales, m)
            torch.cuda.synchronize()
            errs[f"adc_lookup/{dt}/mask={m is not None}"] = compare(
                got, want, ATOL, RTOL)
            del got, want
    one_shot["adc_lookup"] = time_ms(
        lambda: ops.adc_lookup(lutf, codes, None, ids), reps=30)
    k_ms = graph_ms(lambda: ops.adc_lookup(lutf, codes, None, ids),
                    launches=20)
    p_ms = graph_ms(lambda: ref.adc_lookup_ref(lutf, codes, None, ids),
                    launches=2)
    # the library yardstick: one embedding_bag, each CSR row a bag of its
    # Dp entries of the (Dp·K, b) table, giving the scores transposed;
    # unmasked, and its int32 index tensor is made outside the timed call
    bag = codes.int() + torch.arange(D, device=codes.device,
                                     dtype=torch.int32) * K
    table = lutf.permute(1, 2, 0).reshape(D * K, -1).contiguous()
    lib = functools.partial(F.embedding_bag, bag, table, mode="sum")
    compare(lib().T, ref.adc_lookup_ref(lutf, codes), ATOL, RTOL)
    lib_ms = graph_ms(lib, launches=5)
    del bag, table, lib
    all_tiles = torch.arange(index.capacity // BS, device=codes.device)
    qf = QRf.shape[0]
    nbytes = _scan_bytes(lutf, None, codes, ids, all_tiles, BS,
                         qf * index.capacity, 0)
    flops = qf * int(torch.sum(ids >= 0)) * D
    rows["adc_lookup"] = dict(
        shape=dict(b=qf, Dp=D, K=K, N=index.capacity), ms=k_ms,
        plain_ms=p_ms, bytes=nbytes, flops=flops, **_bound(nbytes, flops),
        library_ms=lib_ms)

    # gcd_score: the subspace step's (G, R), and a ragged n
    dev = codes.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    n200 = 200
    pairs = {DIM: (ctx["G"], ctx["R"]),
             n200: (torch.randn((n200, n200), generator=g, device=dev),
                    torch.linalg.qr(torch.randn((n200, n200), generator=g,
                                                device=dev))[0])}
    for n, (G, R) in pairs.items():
        G, R = G.contiguous(), R.contiguous()
        got = ops.gcd_score(G, R)
        want = ref.gcd_score_ref(G, R)
        torch.cuda.synchronize()
        errs[f"gcd_score/n={n}"] = compare(got, want, GCD_ATOL, 0.0)
        check(torch.equal(got, -got.T), f"gcd_score n={n} not antisymmetric")
    G, R = (t.contiguous() for t in pairs[DIM])
    n = DIM
    want = ref.gcd_score_ref(G, R)
    one_shot["gcd_score"] = time_ms(lambda: ops.gcd_score(G, R), reps=50)
    k_ms = graph_ms(lambda: ops.gcd_score(G, R), launches=100)
    p_ms = graph_ms(lambda: ref.gcd_score_ref(G, R), launches=100)
    # the library yardstick: one matmul, [Gᵀ | −Rᵀ] · [R; G] = GᵀR − RᵀG
    lhs = torch.cat([G, -R], dim=0).T.contiguous()           # (n, 2n)
    rhs = torch.cat([R, G], dim=0).contiguous()              # (2n, n)
    lib_ms = graph_ms(lambda: torch.matmul(lhs, rhs), launches=100)
    check(torch.allclose(torch.matmul(lhs, rhs), want, atol=GCD_ATOL),
          "library yardstick computes another function")
    # one n³ product (M = GᵀR) and the n² subtraction; G and R read once,
    # A written once
    flops = 2 * n ** 3 + n * n
    nbytes = 3 * n * n * 4
    rows["gcd_score"] = dict(
        shape=dict(n=n), ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops), library_ms=lib_ms)

    # pq_assign: the index build's encode of all N rows, as ivf.encode runs
    # it, chunk by chunk: the coarse VQ (K = L, sub = n) on X·R, then the PQ
    # codebooks on the residuals to the kernel's lists
    before = ctx["index_before"]
    cents = before.centroids[None].contiguous()               # (1, L, n)
    cbs = before.codebooks.contiguous()                       # (D, K, sub)
    XR = ctx["X"] @ before.R
    serve_flips = {}
    for lo in range(0, N, ivf.ENCODE_ROWS):
        xr = XR[lo:lo + ivf.ENCODE_ROWS]
        lists = ops.pq_assign(xr, cents)
        res = (xr - before.centroids[lists[:, 0].long()]).contiguous()
        codes_c = ops.pq_assign(res, cbs)
        for what, x, C, got in (("coarse_vq", xr, cents, lists),
                                ("pq", res, cbs, codes_c)):
            _merge_flips(serve_flips.setdefault(what, {}), _assign_flips(
                x, C, got, ref.pq_assign_ref(x, C)))
        del xr, lists, res, codes_c
    del XR
    for what, f in serve_flips.items():
        errs[f"pq_assign/serve_{what}"] = f["max_abs_gap"]

    # givens_rotate: the refresh's own operands, R, the coarse centroids and
    # the codebook rows (cross-subspace angles zeroed, as
    # index.maintain.rotate_components does), each bit-equal to the plain
    # version and to what the refresh stored
    delta = ctx["delta"]
    pi, pj = delta.pi.int().contiguous(), delta.pj.int().contiguous()
    sub = DIM // D
    theta_w = torch.where(delta.pi // sub == delta.pj // sub, delta.theta,
                          torch.zeros_like(delta.theta))
    refresh_cases = {
        "R": (before.R, delta.theta, index.R),
        "centroids": (before.centroids, delta.theta, index.centroids),
        "codebook_rows": (before.codebooks.movedim(-2, -3).reshape(-1, DIM),
                          theta_w,
                          index.codebooks.movedim(-2, -3).reshape(-1, DIM)),
    }
    for what, (Xr, th, stored) in refresh_cases.items():
        c, s = torch.cos(th).contiguous(), torch.sin(th).contiguous()
        got = ops.givens_rotate(Xr.contiguous(), pi, pj, c, s)
        want = ref.pair_rotate_ref(Xr, pi, pj, c, s)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"givens_rotate on the refresh's "
              f"{what} is not bit-equal to its plain version")
        check(torch.equal(stored, want), f"the refreshed {what} differs "
              "from the plain rotation")
        errs[f"givens_rotate/refresh_{what}"] = 0.0

    for name in rows:
        rows[name]["max_abs_err"] = max(v for key, v in errs.items()
                                        if key.startswith(name + "/"))
    emit("kernels", max_abs_err=errs, kernels=rows,
         launches=ctx["launches"], one_shot_ms=one_shot,
         serve_p99_stage_ms=stage_ms, launch_floor_ms=launch_floor_ms,
         host_launch_ms=host_launch_ms, serve_pq_assign_flips=serve_flips,
         card=torch.cuda.get_device_name(0))
    return rows, errs


# -- engine -----------------------------------------------------------------


def _stream():
    """The engine phase's request stream, from SEED: ENGINE_REQUESTS row
    lists into a pool of fresh queries, sizes cycling through
    ENGINE_SIZES, about half of each request's rows (none of the first's)
    repeats of rows served before."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    seen, fresh, out = [], 0, []
    for r in range(ENGINE_REQUESTS):
        size = ENGINE_SIZES[r % len(ENGINE_SIZES)]
        reps = (rng.choice(seen, size // 2).tolist() if seen else [])
        new = list(range(fresh, fresh + size - len(reps)))
        fresh += len(new)
        rows = np.array(reps + new)
        rng.shuffle(rows)
        out.append(rows)
        seen.extend(new)
    return out, fresh


def _expected_cache(stream, invalidate_before: set) -> list:
    """What the Engine's LUT cache must do on the stream (no eviction: the
    stream's distinct rows fit in the cache): per request (hits, misses,
    whether a table is built). The cache is cleared before the requests
    in ``invalidate_before``."""
    cached, out = set(), []
    for r, rows in enumerate(stream):
        if r in invalidate_before:
            cached.clear()
        hits = sum(int(i) in cached for i in rows)
        out.append((hits, len(rows) - hits, hits < len(rows)))
        cached.update(int(i) for i in rows)
    return out


def _gcd_delta(learner, R, sample, quantizer):
    """One learner step from the distortion gradient at rotation R."""
    import torch

    Rp = R.clone().requires_grad_(True)
    (G,) = torch.autograd.grad(quantizer.distortion(sample @ Rp), Rp)
    _, delta = learner.update(learner.init_from(R.detach()), G, GCD_LR)
    return delta


def _hold_fused_lut(name, Q, qdelta, cb, colmap, errs, rel, fails) -> None:
    """fused_lut against its plain version: max |kernel − plain| within
    LUT_RTOL of the table's scale, and the int8/uint8 packs of the two
    tables at most one step apart."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.fused_lut(Q, qdelta, cb, colmap)
    want = ref.fused_lut_ref(Q, qdelta, cb, colmap)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    errs[f"fused_lut/{name}"] = err
    rel[name] = err / scale
    if not err <= LUT_RTOL * scale:
        fails.append(f"fused_lut {name}: max abs error {err} beyond "
                     f"{LUT_RTOL} of the scale {scale}")
    for dt in ("int8", "uint8"):
        qg, _ = ops.quantize_luts(got, dt)
        qw, _ = ops.quantize_luts(want, dt)
        step = int((qg.int() - qw.int()).abs().max())
        if step > 1:
            fails.append(f"fused_lut {name}: {dt} codes {step} steps apart")


def phase_engine(ctx: dict, smi: str):
    """The Engine over a fused-refresh IVF state on main's index, held
    against direct searches, an eager refresh and the exact backends."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import obs, rotations, search
    from repro_torch.data import synthetic
    from repro_torch.index import search as index_search
    from repro_torch.kernels import ops, ref
    from repro_torch.metrics import recall_at_k

    index, X, Q = ctx["index"], ctx["X"], ctx["Q"]
    sample = X[:TRAIN]
    fails, errs = [], {}
    t_all = time.perf_counter()

    # the exact backends: exact against the plain product Q·Xᵀ (rows that
    # differ must hold float32 ties), exact_stream against exact
    exact, estate = search.make("exact"), ctx["exact"]
    ex = exact.search(estate, Q, k=10)
    plain_ids = torch.topk(Q @ X.T, 10, dim=1).indices
    differ = torch.nonzero(~(ex.ids.long() == plain_ids).all(1)).squeeze(1)
    tie_gap = 0.0
    for r in differ.tolist():
        q = Q[r].double()
        a = torch.sort(X[ex.ids[r].long()].double() @ q).values
        b = torch.sort(X[plain_ids[r]].double() @ q).values
        tie_gap = max(tie_gap, float((a - b).abs().max()
                                     / b.abs().max()))
    if tie_gap > TIE_GAP:
        fails.append(f"exact differs from the plain Q·Xᵀ top-10 beyond "
                     f"float32 ties (gap {tie_gap})")
    del plain_ids
    t0 = time.perf_counter()
    stream_b = search.make("exact_stream")
    sstate = stream_b.build(None, X, ctx["R"],
                            search.SearchConfig(tile_rows=EXACT_TILE))
    torch.cuda.synchronize()
    t_stream_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    sres = stream_b.search(sstate, Q, k=10)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    if not torch.equal(sres.ids, ex.ids):
        fails.append("exact_stream ids differ from exact")
    t0 = time.perf_counter()
    exact.search(estate, Q, k=10)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    del sstate
    truth = ex.ids

    # the path: counts from 0 here, read after the stream and its checks
    ops.reset_launches()
    expect = {"fused_lut": 0, "ivf_adc": 0}
    ivf, flat = search.make("ivf"), search.make("flat_adc")
    state = ivf.attach(index, nprobe=SERVE_NPROBE, fused_refresh=True)
    state0 = state
    fstate = flat.attach(index, fused_refresh=True)
    # nprobe = L through the fused tables equals the fused flat scan
    qf = Q[:FLAT_QUERIES]
    full = ivf.search(state, qf, k=10, nprobe=L)
    fres = flat.search(fstate, qf, k=10)
    expect["fused_lut"] += 2
    expect["ivf_adc"] += 1
    if not torch.equal(full.ids, fres.ids):
        fails.append("fused nprobe = L ids differ from the fused flat scan")

    g = torch.Generator(device=X.device)
    g.manual_seed(SEED + 3)
    stream, n_fresh = _stream()
    pool = synthetic.sift_like(g, n_fresh, DIM)
    within_at, cross_at = ENGINE_REQUESTS // 3, 2 * ENGINE_REQUESTS // 3
    cache = _expected_cache(stream, {cross_at})
    engine = search.Engine(ivf, state, k=10)
    deltas, refreshes = [], {}
    direct = dict(equal=0, within_rows=0, within_ids_equal=0)
    for r, rows in enumerate(stream):
        if r == within_at:
            d = _gcd_delta(rotations.make("subspace_gcd", sub=DIM // D),
                           engine.state.rot, sample, index.quantizer)
            before = engine.stats()
            engine.refresh(d)
            deltas.append(d)
            refreshes["within"] = dict(
                invariant=ivf.luts_refresh_invariant(state, d),
                theta_max=float(d.theta.abs().max()))
        if r == cross_at:
            d = _gcd_delta(rotations.make("gcd_greedy"), engine.state.rot,
                           sample, index.quantizer)
            mid = engine.stats()
            engine.refresh(d)
            deltas.append(d)
            after = engine.stats()
            refreshes["cross"] = dict(
                invariant=ivf.luts_refresh_invariant(engine.state, d),
                theta_max=float(d.theta.abs().max()),
                invalidations=after["lut_invalidations"]
                - mid["lut_invalidations"],
                epoch=after["lut_epoch"] - mid["lut_epoch"])
        qb = pool[torch.from_numpy(rows).to(X.device)]
        got = engine.search(qb)
        expect["ivf_adc"] += 1
        expect["fused_lut"] += int(cache[r][2])
        want = ivf.search(engine.state, qb, k=10)
        expect["ivf_adc"] += 1
        expect["fused_lut"] += 1
        same = torch.equal(got.ids, want.ids)
        diff = float((got.scores - want.scores).abs().max())
        if within_at <= r < cross_at:
            # cached tables from before the refresh: equal in exact
            # arithmetic, not in float32
            direct["within_rows"] += len(rows)
            direct["within_ids_equal"] += int(
                (got.ids == want.ids).all(1).sum())
            if not torch.allclose(got.scores, want.scores, atol=1e-4,
                                  rtol=1e-4):
                fails.append(f"request {r}: scores off by {diff} after the "
                             "within-subspace refresh")
        else:
            direct["equal"] += int(same)
            if not (same and torch.allclose(got.scores, want.scores,
                                            atol=1e-6, rtol=1e-6)):
                fails.append(f"request {r}: Engine differs from a direct "
                             f"search (ids equal {same}, scores {diff})")
        if r == cross_at - 1:
            st = engine.stats()
            hits = sum(c[0] for c in cache[:r + 1])
            if st["lut_invalidations"] != 0 or st["lut_hits"] != hits \
                    or st["executables"] != before["executables"]:
                fails.append(f"within-subspace refresh: invalidations "
                             f"{st['lut_invalidations']}, hits "
                             f"{st['lut_hits']} (the stream repeats {hits}"
                             f"), executables {before['executables']} -> "
                             f"{st['executables']}")
    if refreshes["within"]["invariant"] is not True \
            or refreshes["cross"]["invariant"] is not False:
        fails.append(f"refresh invariance misjudged: {refreshes}")
    if refreshes["cross"]["invalidations"] != 1 \
            or refreshes["cross"]["epoch"] != 1:
        fails.append(f"GCD-G refresh: {refreshes['cross']}")
    if direct["within_ids_equal"] < 0.99 * direct["within_rows"]:
        fails.append(f"after the within-subspace refresh only "
                     f"{direct['within_ids_equal']} of "
                     f"{direct['within_rows']} rows have the direct "
                     "search's ids")
    st1 = engine.stats()
    want_hits = sum(c[0] for c in cache)
    if st1["lut_hits"] != want_hits or \
            st1["lut_misses"] != sum(c[1] for c in cache):
        fails.append(f"LUT hits {st1['lut_hits']} / misses "
                     f"{st1['lut_misses']}, the stream implies {want_hits}")
    reqs1 = engine.requests

    # the second pass of the stream with int8 tables. A cached table row
    # was built from Q·R₀ of an earlier batch, whose float32 product may
    # round differently at another batch size, and a last-bit difference
    # can move an int8 code by one step: each score may then move by at
    # most one step in every column, Σ_d scale_d
    engine8 = search.Engine(ivf, dataclasses.replace(engine.state,
                                                     lut_dtype="int8"), k=10)
    cache8 = _expected_cache(stream, set())
    direct8 = dict(rows=0, ids_equal=0, max_diff_over_step=0.0)
    for r, rows in enumerate(stream):
        qb = pool[torch.from_numpy(rows).to(X.device)]
        got = engine8.search(qb)
        QRb = ivf.rotate_queries(engine8.state, qb)
        lut8 = ivf.luts(engine8.state, QRb)
        want = ivf.search_prepared(engine8.state, QRb, lut8, k=10)
        expect["ivf_adc"] += 2
        expect["fused_lut"] += int(cache8[r][2]) + 1
        step = lut8[1][..., 0].sum(dim=1, keepdim=True)
        over = float(((got.scores - want.scores).abs() / step).max())
        direct8["rows"] += len(rows)
        direct8["ids_equal"] += int((got.ids == want.ids).all(1).sum())
        direct8["max_diff_over_step"] = max(direct8["max_diff_over_step"],
                                            over)
        if over > 1.0:
            fails.append(f"int8 request {r}: scores {over} steps from a "
                         "direct search")
    if direct8["ids_equal"] < 0.99 * direct8["rows"]:
        fails.append(f"int8 pass: {direct8['ids_equal']} of "
                     f"{direct8['rows']} rows have the direct search's ids")
    st8 = engine8.stats()

    # the end state: the fused state against an eager copy of the index
    # refreshed by the same two deltas, and recall against exact
    state = engine.state
    eager = ivf.attach(index, nprobe=SERVE_NPROBE)
    for d in deltas:
        eager = ivf.refresh(eager, d)
    r_e = ivf.search(eager, Q, k=10)
    probe = obs.RecallProbe(Q, truth, k=10)
    recall = probe.run(lambda q: ivf.search(state, q, k=10))
    r_f = ivf.search(state, Q, k=10)
    expect["ivf_adc"] += 3
    expect["fused_lut"] += 2
    eager_share = float((r_e.ids == r_f.ids).float().mean())
    eager_diff = float((r_e.scores - r_f.scores).abs().max())
    # The two states probe through other float32 products (the fused one
    # at R₀, the eager one against rotated centroids), so a query whose
    # nprobe-th and next lists are a float32 tie may probe another list in
    # each. Every query's scores are held to 1e-4 against the eager state
    # searched over the lists the fused state probed: r_e itself where the
    # lists agree, else a second eager search through the prepared path
    # with the probe pinned to the fused lists. Each such query must also
    # be a tie: every list one state alone probes lies within TIE_GAP (of
    # the query's coarse scale) of the fused nprobe-th coarse score.
    QRf, QRe = ivf.rotate_queries(state, Q), ivf.rotate_queries(eager, Q)
    cf = index_search.coarse_scores(state.index, QRf)
    ce = index_search.coarse_scores(eager.index, QRe)
    vals_f, lists_f = torch.sort(cf, dim=1, descending=True, stable=True)
    lists_e = torch.sort(ce, dim=1, descending=True, stable=True).indices
    flipped = torch.zeros_like(cf, dtype=torch.bool).scatter_(
        1, lists_f[:, :SERVE_NPROBE], True) ^ torch.zeros_like(
        cf, dtype=torch.bool).scatter_(1, lists_e[:, :SERVE_NPROBE], True)
    moved = flipped.any(1)
    edge = vals_f[:, SERVE_NPROBE - 1:SERVE_NPROBE]
    probe_gap = float(((cf - edge).abs() * flipped).amax(1).div(
        cf.abs().amax(1)).max())
    if probe_gap > TIE_GAP:
        fails.append(f"fused and eager refresh probe other lists beyond a "
                     f"float32 tie (gap {probe_gap})")
    want_scores = r_e.scores.clone()
    if moved.any():
        QRm = QRe[moved]
        with _probe_pinned(index_search, lists_f[moved, :SERVE_NPROBE]):
            want_scores[moved] = ivf.search_prepared(
                eager, QRm, ivf.luts(eager, QRm), k=10).scores
        expect["ivf_adc"] += 1
    pinned_diff = float((want_scores - r_f.scores).abs().max())
    if not torch.allclose(want_scores, r_f.scores, atol=1e-4, rtol=1e-4):
        fails.append(f"fused and eager refresh: scores off by {pinned_diff} "
                     "over the same probed lists")
    if eager_share < 0.95:
        fails.append(f"fused and eager refresh: {eager_share} of ids equal")
    if abs(recall - ctx["after_recall"]) > 0.005:
        fails.append(f"recall@10 {recall} against exact, main's after "
                     f"refresh {ctx['after_recall']}")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, n in expect.items():
        if launches[name] != n:
            fails.append(f"{name} launched {launches[name]} times, the path "
                         f"implies {n}")
    t_path = time.perf_counter() - t_all

    # fused_lut against its plain version on the path's operands
    rel = {}
    cb, colmap = index.quantizer.lut_operands()
    QR512 = ivf.rotate_queries(state, Q[:BATCHES[0]])
    for name, qd in (("b512_attach", state0.qdelta),
                     ("b512_after_gcd_g", state.qdelta)):
        _hold_fused_lut(name, QR512, qd, cb, colmap, errs, rel, fails)
    for b in (1, 37, 300):
        qb = ivf.rotate_queries(state, pool[:b])
        _hold_fused_lut(f"b{b}", qb, state.qdelta, cb, colmap, errs, rel,
                        fails)
    levels = torch.cat([cb, 0.5 * cb.flip(1)])            # (2D, K, sub)
    rq_map = torch.eye(D, device=cb.device)[
        torch.arange(2 * D, device=cb.device) % D]
    _hold_fused_lut("rq_depth2", QR512, state.qdelta, levels.contiguous(),
                    rq_map, errs, rel, fails)
    n2, D2 = 512, 64
    q2 = torch.randn((300, n2), generator=g, device=cb.device)
    qd2 = torch.linalg.qr(torch.randn((n2, n2), generator=g,
                                      device=cb.device))[0].contiguous()
    cb2 = torch.randn((D2, K, n2 // D2), generator=g, device=cb.device)
    _hold_fused_lut("n512_D64", q2, qd2, cb2,
                    torch.eye(D2, device=cb.device), errs, rel, fails)

    # times per launch at b = 512
    qd = state.qdelta
    cols = state.lut_cols
    k_ms = graph_ms(lambda: ops.fused_lut(QR512, qd, cb, colmap, cols=cols),
                    launches=50)
    p_ms = graph_ms(lambda: ref.fused_lut_ref(QR512, qd, cb, colmap),
                    launches=20)
    cbT = cb.transpose(1, 2).contiguous()                  # (D, sub, K)
    b512 = QR512.shape[0]

    def two_calls():
        QL = torch.matmul(QR512, qd).view(b512, D, -1).transpose(0, 1)
        return torch.bmm(QL, cbT)                          # (D, b, K)

    lib_err = float((two_calls().transpose(0, 1)
                     - ref.fused_lut_ref(QR512, qd, cb, colmap)).abs().max())
    lib_ms = graph_ms(two_calls, launches=20)
    eager_lut_ms = graph_ms(lambda: index.quantizer.adc_tables(QR512),
                            launches=20)
    Dp, _, sub = cb.shape
    nbytes = 4 * (b512 * DIM + DIM * DIM + Dp * K * sub + b512 * Dp * K + Dp)
    flops = 2 * b512 * DIM * DIM + 2 * b512 * Dp * K * sub
    row = dict(shape=dict(b=b512, n=DIM, Dp=Dp, K=K, sub=sub), ms=k_ms,
               plain_ms=p_ms, bytes=nbytes, flops=flops,
               **_bound(nbytes, flops), library_ms=lib_ms,
               library="two calls: torch.matmul(Q, qdelta), then torch.bmm "
                       "over the subspaces",
               library_max_abs_err=lib_err, eager_lut_ms=eager_lut_ms,
               max_abs_err=max(v for v in errs.values()),
               rel_err=rel)

    def per_bucket(reqs):
        out = {}
        for rec in reqs:
            out.setdefault(rec["bucket"], obs.Distribution(
                "latency_ms", window=len(reqs))).observe(rec["latency_ms"])
        return {str(b): dict(n=d.count, p50=d.percentile(50),
                             p99=d.percentile(99))
                for b, d in sorted(out.items())}

    keys = ("requests", "queries", "compiles", "executables", "refreshes",
            "lut_hits", "lut_misses", "lut_hit_rate", "lut_invalidations",
            "lut_epoch", "lut_cached_rows", "latency_ms_p50",
            "latency_ms_p99")
    emit("engine", requests=ENGINE_REQUESTS, sizes=list(ENGINE_SIZES),
         fresh_rows=n_fresh, rows=sum(len(r) for r in stream),
         nprobe=SERVE_NPROBE, refreshes=refreshes,
         float32={k: st1[k] for k in keys}, int8={k: st8[k] for k in keys},
         latency_ms_by_bucket=dict(float32=per_bucket(reqs1),
                                   int8=per_bucket(engine8.requests)),
         direct_searches=direct, int8_direct_searches=direct8,
         eager_ids_equal_share=eager_share, eager_max_score_diff=eager_diff,
         eager_probe_flips=int(moved.sum()), eager_probe_tie_gap=probe_gap,
         eager_pinned_max_score_diff=pinned_diff,
         recall_at_10=recall, main_after_refresh_recall=ctx["after_recall"],
         exact=dict(rows_differing_from_plain=int(differ.numel()),
                    max_tie_gap=tie_gap, search_s=t_exact,
                    stream_search_s=t_stream,
                    stream_build_s=t_stream_build),
         launches=launches, expected_launches=expect, fused_lut=row,
         path_s=t_path, total_s=time.perf_counter() - t_all, card=smi,
         fails=fails)
    check(not fails, "; ".join(fails))
    return {"fused_lut": row}, errs, launches


# -- train ------------------------------------------------------------------


class _StepTimer:
    """CUDA events at the marks of each train step (``make_train_step``'s
    ``marks``: start, forward, backward, adamw, rotation) or decode step
    (``serve_decode``'s)."""

    def __init__(self):
        self.steps = []

    def start(self) -> None:
        self.steps.append([])
        self("start")

    def __call__(self, name: str) -> None:
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((name, ev))

    def split_ms(self) -> dict:
        """Median device milliseconds of each part over the steps."""
        import torch

        torch.cuda.synchronize()
        parts: dict[str, list] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                parts.setdefault(name, []).append(a.elapsed_time(b))
        self.steps = []
        return {k: statistics.median(v) for k, v in parts.items()}


@contextlib.contextmanager
def _last_call(name: str, into: dict, module=None):
    """Inside the block, keep a copy of the positional operands of the last
    call of ``module.<name>`` (default: ``kernels.ops``) in ``into[name]``;
    the call itself goes on as before and launches (and counts) as it
    would."""
    import torch

    from repro_torch.kernels import ops

    module = ops if module is None else module
    real = getattr(module, name)

    def spy(*args, **kwargs):
        into[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                           for a in args)
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _probe_pinned(index_search, lists):
    """Inside the block, ``index_search.probe`` returns ``lists`` (b, p)
    and each one's coarse score from the searched index, in place of that
    index's own top-p: a search then scans exactly these lists."""
    real = index_search.probe

    def pinned(index, QR, nprobe):
        assert lists.shape == (QR.shape[0], nprobe)
        return lists, index_search.coarse_scores(index, QR).gather(1, lists)

    index_search.probe = pinned
    try:
        yield
    finally:
        index_search.probe = real


def _run_steps(step, state, batches, timer: _StepTimer):
    """Drive ``step`` over the batches; losses and host-clock ms per step
    (synchronised before and after)."""
    import torch

    losses, host_ms, last = [], [], None
    for h, pos in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.start()
        state, last = step(state, h, pos)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(last["loss"]))
    check(all(math.isfinite(v) for v in losses), f"a loss is not finite: "
          f"{losses}")
    return state, losses, host_ms, last


def _launch_delta(before: dict) -> dict:
    from repro_torch.kernels import ops

    return {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()
            if v != before.get(k, 0)}


def _expect(what: str, got: dict, want: dict) -> None:
    check(got == want, f"{what}: launches {got}, the path implies {want}")


def _evaluate(model, cfg, sample_ids, hist, truth):
    """Fig. 3 distortion on fresh item-tower outputs of the OPQ sample, then
    Table 1: the whole corpus through the item tower and the index layer's
    pq_assign, queries scored by ADC (adc_lookup), p@k / r@k against the
    latent-similarity truth. Returns the metrics, the corpus codes (uint8)
    and the ADC scores."""
    import torch

    from repro_torch.core import index_layer as il
    from repro_torch.models import recsys

    with torch.no_grad():
        R = model.index.R
        v, _ = recsys.item_tower(model, sample_ids, cfg)
        dist = float(il.quantizer(model.index).distortion(v @ R))
        del v
        ids = torch.arange(cfg.item_vocab, device=R.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vecs = torch.cat([recsys.item_tower(model, ids[s:s + TOWER_CHUNK],
                                            cfg)[0]
                          for s in range(0, cfg.item_vocab, TOWER_CHUNK)])
        vecs /= torch.clamp(torch.linalg.vector_norm(vecs, dim=-1,
                                                     keepdim=True), min=1e-6)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codes = il.encode(model.index, vecs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del vecs
        check(codes.shape == (cfg.item_vocab, cfg.index.num_subspaces)
              and int(codes.min()) >= 0
              and int(codes.max()) < cfg.index.num_codewords, "corpus codes")
        scores = recsys.twotower_retrieve_adc(model, hist, codes, cfg)
        check(bool(torch.all(torch.isfinite(scores))), "non-finite ADC score")
        top = torch.topk(scores, EVAL_K, dim=1).indices
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        hits = (top[:, :, None] == truth[:, None, :]).any(-1).sum(1).double()
    ev = dict(distortion=dist, p_at_50=float(hits.mean()) / EVAL_K,
              r_at_50=float(hits.mean()) / truth.shape[1],
              item_tower_s=t1 - t0, encode_s=t2 - t1, retrieve_s=t3 - t2)
    return ev, codes.to(torch.uint8), scores


def phase_train(smi: str) -> dict:
    import torch

    from repro_torch import device, rotations
    from repro_torch.configs import paper_twotower
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.core import index_layer as il
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import recsys
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_state as ts

    cfg = paper_twotower.make_config()
    peaks, counts, secs = {}, {}, {}

    def part(name: str, before: dict) -> None:
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts[name] = _launch_delta(before)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED + 2)
    log = synthetic.ClickLog(SEED, cfg.item_vocab, dim=CLICK_DIM)
    model = recsys.TwoTower.init(g, cfg._replace(index=None))
    warm_batches = [log.batch(1000 + i, TRAIN_BATCH, cfg.hist_len)
                    for i in range(WARMUP_STEPS)]
    joint_batches = [log.batch(2000 + i, TRAIN_BATCH, cfg.hist_len)
                     for i in range(JOINT_STEPS)]
    hist, truth = log.eval_queries(7, EVAL_QUERIES, cfg.hist_len,
                                   k_truth=EVAL_K)
    secs["data"] = time.perf_counter() - t_all
    part("data", {})

    # 1. warm-up without the index layer: one embedding_bag per step
    ocfg = opt_lib.OptimizerConfig(
        lr=TRAIN_LR, total_steps=JOINT_STEPS, warmup_steps=SCHEDULE_WARMUP,
        rotation=rotations.RotationConfig("gcd_greedy", lr=ROT_LR))
    timer = _StepTimer()
    before = dict(ops.LAUNCHES)
    step = ts.make_train_step(lambda p, h, pos: recsys.twotower_loss(
        p, h, pos, cfg, use_index=False), ocfg, marks=timer)
    _, warm_losses, warm_ms, _ = _run_steps(
        step, ts.init_state(None, model, ocfg), warm_batches, timer)
    warm_split = timer.split_ms()
    part("warmup", before)
    _expect("warm-up", counts["warmup"], {"embedding_bag": WARMUP_STEPS})

    # 2. OPQ warm start of (R, codebooks) on item-tower outputs
    before = dict(ops.LAUNCHES)
    sample_ids = torch.arange(OPQ_SAMPLE, device=g.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        v, _ = recsys.item_tower(model, sample_ids, cfg)
    model.index = il.warm_start(g, v, cfg.index, opq_iters=OPQ_ITERS,
                                kmeans_iters=1)
    torch.cuda.synchronize()
    secs["opq"] = time.perf_counter() - t0
    opq_X = (v @ model.index.R).detach()
    orth_warm = float(rotations.orthogonality_error(model.index.R.detach()))
    check(orth_warm <= 1e-5, f"OPQ warm-start orthogonality error "
          f"{orth_warm}")
    del v
    part("opq", before)
    # one k-means assign to start, then per iteration the k-means refresh,
    # the Procrustes target and the recorded distortion
    _expect("OPQ", counts["opq"], {"pq_assign": 1 + 3 * OPQ_ITERS})
    start = {k: p.detach().clone()
             for k, p in opt_lib.named_leaves(model).items()}

    # 3. joint steps from the warm start: GCD-G, then the frozen control
    joint_loss = functools.partial(_joint_loss, cfg=cfg)
    runs, ops_ctx = {}, {}
    per_step = {"gcd_greedy": {"embedding_bag": 1, "pq_assign": 2,
                               "gcd_score": 1, "givens_rotate": 1},
                "frozen": {"embedding_bag": 1, "pq_assign": 2}}
    for spec in ("gcd_greedy", "frozen"):
        with torch.no_grad():
            for k, p in opt_lib.named_leaves(model).items():
                p.copy_(start[k])
        scfg = ocfg._replace(rotation=rotations.RotationConfig(spec,
                                                               lr=ROT_LR))
        before = dict(ops.LAUNCHES)
        step = ts.make_train_step(joint_loss, scfg, emit_deltas=True,
                                  marks=timer)
        seen = {}
        with _last_call("gcd_score", seen):
            _, losses, host_ms, last = _run_steps(
                step, ts.init_state(None, model, scfg), joint_batches, timer)
        split = timer.split_ms()
        part(f"joint/{spec}", before)
        _expect(f"joint steps, {spec}", counts[f"joint/{spec}"],
                {k: JOINT_STEPS * v for k, v in per_step[spec].items()})
        R = model.index.R.detach()
        moved = float((R - start["index/R"]).abs().max())
        orth = float(rotations.orthogonality_error(R))
        if spec == "frozen":
            check(torch.equal(R, start["index/R"]),
                  "frozen R differs from the warm start")
        else:
            check(orth <= 1e-5, f"GCD orthogonality error {orth}")
            check(moved > 0.0, "GCD left R at the warm start")
            delta = last["rotation_deltas"]["index/R"]
            h, pos = joint_batches[-1]
            check(cfg.scoring == "cosine", "the ADC tables below assume "
                  "cosine scoring")
            with torch.no_grad():
                v, _ = recsys.item_tower(model, pos, cfg)
                # the eval queries' ADC tables, built as
                # recsys.twotower_retrieve_adc builds them (this user-tower
                # pass is outside every part and so not counted)
                u = recsys.user_tower(model, hist, cfg)
                u = u / torch.clamp(torch.linalg.vector_norm(
                    u, dim=-1, keepdim=True), min=1e-6)
                ops_ctx.update(
                    R=R.clone(), pi=delta.pi, pj=delta.pj, theta=delta.theta,
                    assign_X=(v @ R).contiguous(), opq_X=opq_X,
                    codebooks=model.index.codebooks.detach().clone(),
                    table=model.item_table.detach(), hist=h,
                    score_G=seen["gcd_score"][0], score_R=seen["gcd_score"][1],
                    adc_lut=il.quantizer(model.index).adc_tables(
                        u @ R).contiguous())
            del v, u
        before = dict(ops.LAUNCHES)
        ev, codes, scores = _evaluate(model, cfg, sample_ids, hist, truth)
        part(f"eval/{spec}", before)
        _expect(f"eval, {spec}", counts[f"eval/{spec}"],
                {"pq_assign": 2, "embedding_bag": 1, "adc_lookup": 1})
        if spec == "gcd_greedy":
            ops_ctx.update(corpus_codes=codes, adc_scores=scores)
        del codes, scores
        runs[spec] = dict(losses=losses, step_host_ms=host_ms,
                          step_host_ms_median=statistics.median(host_ms),
                          step_device_ms_median=split,
                          r_moved_max_abs=moved, orthogonality_error=orth,
                          **ev)
    del start
    launches = {}                    # the path's: every part's, summed
    for c in counts.values():
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    emit("train", config=cfg.name, item_vocab=cfg.item_vocab,
         embed_dim=cfg.embed_dim, tower_dims=list(cfg.tower_dims),
         hist_len=cfg.hist_len, index=cfg.index._asdict(),
         batch=TRAIN_BATCH, warmup_steps=WARMUP_STEPS,
         joint_steps=JOINT_STEPS, opq_sample=OPQ_SAMPLE, opq_iters=OPQ_ITERS,
         lr=TRAIN_LR, rotation_lr=ROT_LR, eval_queries=EVAL_QUERIES,
         warmup=dict(losses=warm_losses, step_host_ms=warm_ms,
                     step_device_ms_median=warm_split),
         warm_start_orthogonality_error=orth_warm,
         runs=runs, seconds=secs, launches=launches,
         launches_by_part=counts, peak_memory_bytes=peaks,
         gcd_below_frozen_distortion=(runs["gcd_greedy"]["distortion"]
                                      < runs["frozen"]["distortion"]),
         total_s=time.perf_counter() - t_all, card=smi,
         cuts=dict(batch=dict(run=TRAIN_BATCH, config=RECSYS_SHAPES[
                       "train_batch"].params["batch"]),
                   steps=f"{WARMUP_STEPS} warm-up + {JOINT_STEPS} joint",
                   opq_iters=OPQ_ITERS))
    for name in TRAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the train path")
    return dict(launches=launches, model=model, **ops_ctx)


def _joint_loss(p, h, pos, cfg):
    from repro_torch.models import recsys

    return recsys.twotower_loss(p, h, pos, cfg, use_index=True)


# -- train kernels -----------------------------------------------------------


def _assign_flips(X, C, got, want) -> dict:
    """pq_assign codes against the plain version's: every differing
    (row, subspace) must be a float32 tie, the two choices' plain scores
    ‖c‖² − 2⟨x, c⟩ (taken in float64) within ASSIGN_GAP of the scale
    ‖x_d‖² + max ‖c‖²."""
    import torch

    flip = got != want
    out = dict(flips=int(flip.sum()), entries=int(flip.numel()),
               max_abs_gap=0.0, max_rel_gap=0.0)
    if out["flips"]:
        r, d = torch.nonzero(flip, as_tuple=True)
        D, _, sub = C.shape
        x = X.view(X.shape[0], D, sub)[r, d].double()
        cg = C[d, got[r, d].long()].double()
        cw = C[d, want[r, d].long()].double()
        sg = (cg * cg).sum(-1) - 2 * (x * cg).sum(-1)
        sw = (cw * cw).sum(-1) - 2 * (x * cw).sum(-1)
        scale = (x * x).sum(-1) + torch.maximum((cg * cg).sum(-1),
                                                (cw * cw).sum(-1))
        out["max_abs_gap"] = float((sg - sw).abs().max())
        out["max_rel_gap"] = float(((sg - sw).abs() / scale).max())
    check(out["max_rel_gap"] <= ASSIGN_GAP,
          f"a pq_assign code differs beyond a float32 tie: {out}")
    return out


def _merge_flips(into: dict, f: dict) -> None:
    """Add one chunk's ``_assign_flips`` to a running total."""
    for key in ("flips", "entries"):
        into[key] = into.get(key, 0) + f[key]
    for key in ("max_abs_gap", "max_rel_gap"):
        into[key] = max(into.get(key, 0.0), f[key])


def _bag_error(got, want, valid_bag) -> float:
    """Max |got − want|, held to BAG_RTOL of max |want|; bags without a
    real entry must be exact zeros."""
    import torch

    check(got.shape == want.shape, "embedding_bag shape")
    check(bool(torch.all(got[~valid_bag] == 0)),
          "a padded or empty bag is not an exact zero")
    err = float((got - want).abs().max())
    rel = err / (float(want.abs().max()) or 1.0)
    check(rel <= BAG_RTOL, f"embedding_bag relative error {rel}")
    return err


def phase_train_kernels(ctx: dict) -> dict:
    """givens_rotate, pq_assign and embedding_bag against their plain
    versions on the train phase's operands, plus ragged shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref

    dev = ctx["R"].device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    rows, errs, extra = {}, {}, {}

    # givens_rotate: the last GCD step's pairs on R, an odd n with unpaired
    # columns, and the backward on a (16384, 512) X
    R, theta = ctx["R"].contiguous(), ctx["theta"]
    pi, pj = ctx["pi"].int().contiguous(), ctx["pj"].int().contiguous()
    c, s = torch.cos(theta).contiguous(), torch.sin(theta).contiguous()
    n, p = R.shape[1], pi.numel()
    cases = {"R": (R, pi, pj, c, s)}
    perm = torch.randperm(513, generator=g, device=dev)
    th = 0.1 * torch.randn(200, generator=g, device=dev)
    cases["odd_n"] = (torch.randn((1000, 513), generator=g, device=dev),
                      perm[:200].int().contiguous(),
                      perm[200:400].int().contiguous(),
                      torch.cos(th), torch.sin(th))
    for name, args in cases.items():
        got = ops.givens_rotate(*args)
        want = ref.pair_rotate_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"givens_rotate {name} is not "
              "bit-equal to its plain version")
        errs[f"givens_rotate/{name}"] = 0.0
    Xb = torch.randn((TRAIN_BATCH, n), generator=g,
                     device=dev).requires_grad_(True)
    tb = theta.clone().requires_grad_(True)
    dY = torch.randn((TRAIN_BATCH, n), generator=g, device=dev)
    a = torch.autograd.grad(ops.apply_pair_rotations(Xb, pi, pj, tb),
                            (Xb, tb), dY)
    b = torch.autograd.grad(ref.apply_pair_rotations_ref(Xb, pi, pj, tb),
                            (Xb, tb), dY)
    check(torch.equal(a[0], b[0]), "givens_rotate backward dX is not "
          "bit-equal to autograd of the plain version")
    dth = float((a[1] - b[1]).abs().max()) / float(b[1].abs().max())
    check(dth <= DTHETA_RTOL, f"givens_rotate dθ relative error {dth}")
    errs["givens_rotate/backward_dX"] = 0.0
    extra["givens_rotate"] = dict(backward_dtheta_rel=dth)
    Xd = Xb.detach()
    k_ms = graph_ms(lambda: ops.givens_rotate(R, pi, pj, c, s), launches=100)
    p_ms = graph_ms(lambda: ref.pair_rotate_ref(R, pi, pj, c, s),
                    launches=100)
    # the library yardstick: one matmul by the dense Δ, built outside
    delta = ref.pair_rotate_ref(torch.eye(n, device=dev), pi, pj, c, s)
    check(torch.allclose(R @ delta, ref.pair_rotate_ref(R, pi, pj, c, s),
                         atol=1e-6), "library yardstick computes another "
          "function")
    lib_ms = graph_ms(lambda: torch.matmul(R, delta), launches=100)
    extra["givens_rotate"].update(
        ms_16384=graph_ms(lambda: ops.givens_rotate(Xd, pi, pj, c, s),
                          launches=20),
        library_ms_16384=graph_ms(lambda: torch.matmul(Xd, delta),
                                  launches=20))
    m = R.shape[0]
    nbytes = 2 * m * n * 4 + 4 * p * 4
    flops = 6 * m * p
    rows["givens_rotate"] = dict(
        shape=dict(m=m, n=n, pairs=p), ms=k_ms, plain_ms=p_ms, bytes=nbytes,
        flops=flops, **_bound(nbytes, flops), library_ms=lib_ms)
    del Xb, Xd, dY, a, b

    # pq_assign: a joint step's XR, the OPQ sample's XR, the coarse-VQ shape
    # (K = 1024, sub = 256) and an m that is not a multiple of the tile
    C = ctx["codebooks"].contiguous()
    Xc = synthetic.sift_like(g, 100_003, 256)
    assign_cases = {
        "joint_step": (ctx["assign_X"], C),
        "opq_sample": (ctx["opq_X"].contiguous(), C),
        "coarse_vq": (Xc, Xc[:1024][None].contiguous()),
        "ragged_m": (ctx["assign_X"][:1001].contiguous(),
                     C[:, :200].contiguous()),
    }
    flips = {}
    for name, (X, Cb) in assign_cases.items():
        got = ops.pq_assign(X, Cb)
        want = ref.pq_assign_ref(X, Cb)
        torch.cuda.synchronize()
        flips[name] = _assign_flips(X, Cb, got, want)
        errs[f"pq_assign/{name}"] = flips[name]["max_abs_gap"]
        del got, want
    X = ctx["assign_X"]
    mq, nq = X.shape
    D, K, sub = C.shape
    k_ms = graph_ms(lambda: ops.pq_assign(X, C), launches=20)
    p_ms = graph_ms(lambda: ref.pq_assign_ref(X, C), launches=2)
    extra["pq_assign"] = dict(flips=flips, ms_coarse_vq=graph_ms(
        lambda: ops.pq_assign(Xc, assign_cases["coarse_vq"][1]), launches=5))
    nbytes = mq * nq * 4 + D * K * sub * 4 + mq * D * 4
    flops = 2 * mq * nq * K
    rows["pq_assign"] = dict(
        shape=dict(m=mq, n=nq, D=D, K=K, sub=sub), ms=k_ms, plain_ms=p_ms,
        bytes=nbytes, flops=flops, **_bound(nbytes, flops), library_ms=None)
    del Xc, assign_cases

    # embedding_bag: the last joint batch's histories over the item table,
    # then weights, extra padding and empty bags
    table, hist = ctx["table"], ctx["hist"]
    B, Lh = hist.shape
    idx = hist.reshape(-1).contiguous()
    bag = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(Lh)
    got = ops.embedding_bag(table, idx, bag, B)
    want = ref.embedding_bag_ref(table, idx, bag, B)
    torch.cuda.synchronize()
    has = (hist >= 0).any(1)
    errs["embedding_bag/main"] = _bag_error(got, want, has)
    idx2 = torch.where(torch.rand(idx.shape, generator=g, device=dev) < 0.2,
                       -1, idx).int()
    bag2 = 2 * bag                           # odd bags have no entries
    idx2[bag2 == 6] = -1                     # bag 6: entries, all padding
    w = torch.randn(idx.shape, generator=g, device=dev)
    got = ops.embedding_bag(table, idx2, bag2, 2 * B + 1, w)
    want = ref.embedding_bag_ref(table, idx2, bag2, 2 * B + 1, w)
    torch.cuda.synchronize()
    has2 = torch.zeros(2 * B + 1, dtype=torch.bool, device=dev)
    has2[bag2[idx2 >= 0].long()] = True
    errs["embedding_bag/weighted_padded_empty"] = _bag_error(got, want, has2)
    del got, want
    k_ms = graph_ms(lambda: ops.embedding_bag(table, idx, bag, B),
                    launches=20)
    p_ms = graph_ms(lambda: ref.embedding_bag_ref(table, idx, bag, B),
                    launches=2)
    # the library yardstick: F.embedding_bag over the unpadded entries with
    # their offsets, built outside the timed call
    keep = idx >= 0
    lib_idx = idx[keep].long()
    offsets = torch.searchsorted(bag[keep].contiguous(),
                                 torch.arange(B, dtype=torch.int32,
                                              device=dev)).long()
    lib = functools.partial(F.embedding_bag, lib_idx, table, offsets,
                            mode="sum")
    check(torch.allclose(lib(), ref.embedding_bag_ref(table, idx, bag, B),
                         atol=1e-6), "library yardstick computes another "
          "function")
    lib_ms = graph_ms(lib, launches=5)
    w_keep = w[keep].contiguous()
    extra["embedding_bag"] = dict(
        weighted_ms=graph_ms(lambda: ops.embedding_bag(table, idx, bag, B, w),
                             launches=20),
        weighted_library_ms=graph_ms(functools.partial(
            F.embedding_bag, lib_idx, table, offsets, mode="sum",
            per_sample_weights=w_keep), launches=5))
    valid = int(keep.sum())
    unique_rows = int(torch.unique(lib_idx).numel())
    nbytes = unique_rows * table.shape[1] * 4 + idx.numel() * 8 \
        + B * table.shape[1] * 4
    flops = valid * table.shape[1]
    rows["embedding_bag"] = dict(
        shape=dict(V=table.shape[0], dim=table.shape[1], bags=B,
                   entries=idx.numel(), valid=valid, unique_rows=unique_rows),
        ms=k_ms, plain_ms=p_ms, bytes=nbytes, flops=flops,
        **_bound(nbytes, flops), library_ms=lib_ms)

    # adc_lookup: the eval retrieval's own tables (256, 64, 256), a 64 KiB
    # float32 row past the default 48 KiB of shared memory, over the whole
    # encoded corpus; first the tables are shown to be the path's
    lut, corpus = ctx["adc_lut"], ctx["corpus_codes"]
    got = ops.adc_lookup(lut, corpus)
    compare(got, ctx["adc_scores"], ATOL, RTOL)
    want = ref.adc_lookup_ref(lut, corpus)
    torch.cuda.synchronize()
    errs["adc_lookup/train_corpus"] = compare(got, want, ATOL, RTOL)
    del got, want
    extra["adc_lookup"] = dict(
        shape=dict(b=lut.shape[0], Dp=lut.shape[1], K=lut.shape[2],
                   N=corpus.shape[0]),
        ms=graph_ms(lambda: ops.adc_lookup(lut, corpus), launches=5))

    # gcd_score: the last GCD step's (G, R) at n = 512
    G, Rs = ctx["score_G"], ctx["score_R"]
    got = ops.gcd_score(G, Rs)
    want = ref.gcd_score_ref(G, Rs)
    torch.cuda.synchronize()
    n = G.shape[0]
    errs[f"gcd_score/train_n={n}"] = compare(got, want, GCD_ATOL, 0.0)
    check(torch.equal(got, -got.T), f"gcd_score n={n} not antisymmetric")
    extra["gcd_score"] = dict(n=n, ms=graph_ms(
        lambda: ops.gcd_score(G, Rs), launches=100))

    for name in rows:
        rows[name]["max_abs_err"] = max(v for key, v in errs.items()
                                        if key.startswith(name + "/"))
    emit("train_kernels", max_abs_err=errs, kernels=rows, extra=extra,
         launches=ctx["launches"], card=torch.cuda.get_device_name(0))
    return rows, errs


# -- decode -----------------------------------------------------------------


def _fit_codebooks(g, params, cache, cfg) -> None:
    """Per layer, PQ.fit on the prompt's K·R and V·R (R from init) in
    place of the init's random codebooks."""
    import torch

    from repro_torch import quant

    kvq, hd = params["kvq"], cfg.head_dim
    for layer in range(cfg.num_layers):
        for x, rot, cb in ((cache.k, "rot_k", "cb_k"),
                           (cache.v, "rot_v", "cb_v")):
            X = x[layer].reshape(-1, hd).float() @ kvq[rot][layer].float()
            pq, _ = quant.PQ.fit(g, X, cfg.kv_quant.pq_cfg, iters=FIT_ITERS)
            with torch.no_grad():
                kvq[cb][layer] = pq.codebooks.to(kvq[cb].dtype)


def _tile_prompt_codes(cache, prompt_len: int, length: int):
    """Fill positions prompt_len … length−1 of both code tensors by tiling
    the prompt's own codes; return the cache with ``length`` set."""
    import torch

    for codes in (cache.k_codes, cache.v_codes):
        for s0 in range(prompt_len, length, prompt_len):
            n = min(prompt_len, length - s0)
            codes[:, :, :, s0:s0 + n] = codes[:, :, :, :n]
    return cache._replace(length=torch.full_like(cache.length, length))


def _decode_layer_split(params, cache, cfg, token) -> dict:
    """Median device milliseconds of each part of a layer's decode step
    (``serve_decode``'s ``marks``, a CUDA event each), over every layer of
    SPLIT_REPS steps at the cache's full length; "head" is the final norm
    and logits, once a step. Each step writes the cache's last position
    again."""
    from repro_torch.models import transformer as tfm

    last = cache._replace(length=cache.length - 1)
    timer = _StepTimer()
    for _ in range(SPLIT_REPS):
        timer.start()
        tfm.serve_decode(params, token, last, cfg, marks=timer)
    return timer.split_ms()


def phase_decode(smi: str) -> dict:
    import numpy as np
    import torch

    from repro_torch import configs, device
    from repro_torch.core import kv_quant
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    spec = configs.get(DECODE_ARCH)
    cfg = spec.config_for_shape(DECODE_SHAPE)
    dense_cfg = cfg._replace(kv_quant=None)
    shape = spec.shapes[DECODE_SHAPE].params
    S, B, L = shape["seq_len"], shape["global_batch"], cfg.num_layers
    check(shape.get("pq_cache") and cfg.kv_quant is not None,
          f"{DECODE_SHAPE} does not switch the PQ cache on")
    peaks, counts, secs = {}, {}, {}

    def part(name: str, before: dict) -> None:
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts[name] = _launch_delta(before)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    g = device.generator(SEED + 4)
    params = tfm.init_params(g, cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT_LEN))).to(params["embed"].device)
    secs["init"] = time.perf_counter() - t_all
    part("init", {})

    with torch.no_grad():
        # 1. the prompt through a dense cache: each layer's K and V
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        dense_logits, dcache = tfm.serve_prefill(params, prompt, dense_cfg)
        torch.cuda.synchronize()
        secs["prefill_dense"] = time.perf_counter() - t0
        part("prefill_dense", before)
        _expect("dense prefill", counts["prefill_dense"], {})

        # 2. the codebooks, fitted per layer on the prompt's K·R and V·R
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        _fit_codebooks(g, params, dcache, cfg)
        torch.cuda.synchronize()
        secs["fit"] = time.perf_counter() - t0
        del dcache
        part("fit", before)
        _expect("codebook fit", counts["fit"],
                {"pq_assign": 2 * L * FIT_ITERS})

        # 3. the PQ prefill into a cache of S positions, then the tiling
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        logits, cache = tfm.serve_prefill(params, prompt, cfg, max_len=S)
        torch.cuda.synchronize()
        secs["prefill"] = time.perf_counter() - t0
        check(torch.equal(logits, dense_logits), "the PQ prefill's logits "
              "differ from the dense prefill's (its attention is dense)")
        cache = _tile_prompt_codes(cache, PROMPT_LEN, S - DECODE_TOKENS)
        part("prefill", before)
        _expect("PQ prefill", counts["prefill"], {"pq_assign": 2 * L})
        cache_ptrs = [t.data_ptr() for t in cache[:2]]

        # 4. greedy decode: the last token attends over all S positions
        before = dict(ops.LAUNCHES)
        tok = logits.argmax(-1)
        host_ms, out_tokens, seen = [], [], {}
        for i in range(DECODE_TOKENS):
            with contextlib.ExitStack() as spies:
                if i == DECODE_TOKENS - 1:   # the last layer's operands
                    spies.enter_context(_last_call("adc_batch", seen))
                    spies.enter_context(_last_call(
                        "adc_decode_attention", seen, module=kv_quant))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = tfm.serve_decode(params, tok, cache, cfg)
                torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(logits).all()) and logits.shape
                  == (B, cfg.vocab_size), f"decode step {i}: logits")
            tok = logits.argmax(-1)
            out_tokens.append(int(tok[0]))
        part("decode", before)
        _expect("decode", counts["decode"],
                {"adc_batch": L * DECODE_TOKENS,
                 "pq_assign": 2 * L * DECODE_TOKENS})
        check(int(cache.length[0]) == S, f"cache length {cache.length}")
        check([t.data_ptr() for t in cache[:2]] == cache_ptrs,
              "decode did not write the cache in place")

        # 5. compressed against dense attention, the last layer, every
        # position
        kvp, q, kc, vc, mask = seen["adc_decode_attention"]
        check(bool(mask.all()), "the last token's mask is not all of S")
        got = kv_quant.adc_decode_attention(kvp, q, kc, vc, mask)
        khat, vhat = kv_quant.decode_k(kvp, kc), kv_quant.decode_v(kvp, vc)
        want = layers.decode_attention(q.float(), khat, vhat,
                                       torch.full((B,), S, device=q.device))
        del khat, vhat
        attn_err = float((got - want).abs().max())
        attn_rel = attn_err / float(want.abs().max())
        check(attn_rel <= ATTN_RTOL, f"compressed attention is {attn_rel} "
              "(relative) from dense attention over the decoded cache")
        del got, want
        split = _decode_layer_split(params, cache, cfg, tok)
        torch.cuda.synchronize()     # the check's peak; its launches are
        peaks["attention_check"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()    # not the path's

        # 6. the quantization's effect on logits, PQ against a dense cache,
        # both fed the dense path's greedy tokens
        before = dict(ops.LAUNCHES)
        short = PROMPT_LEN + DECODE_TOKENS
        lp, cp = tfm.serve_prefill(params, prompt, cfg, max_len=short)
        ld, cd = tfm.serve_prefill(params, prompt, dense_cfg, max_len=short)
        agree, gaps = [], []
        for _ in range(DECODE_TOKENS):
            tok = ld.argmax(-1)
            lp, cp = tfm.serve_decode(params, tok, cp, cfg)
            ld, cd = tfm.serve_decode(params, tok, cd, dense_cfg)
            agree.append(bool((lp.argmax(-1) == ld.argmax(-1)).all()))
            gaps.append(float((lp - ld).abs().max()))
        del cp, cd
        part("quant_effect", before)
        _expect("PQ against dense", counts["quant_effect"],
                {"adc_batch": L * DECODE_TOKENS,
                 "pq_assign": 2 * L * (DECODE_TOKENS + 1)})

    launches = {}
    for c in counts.values():
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    hd, D = cfg.head_dim, cfg.kv_quant.num_subspaces
    cache_bytes = sum(t.numel() * t.element_size() for t in cache[:2])
    dense_bytes = 2 * L * B * cfg.num_kv_heads * S * hd * 2
    emit("decode", config=cfg.name, shape=DECODE_SHAPE, layers=L,
         d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, kv_quant=cfg.kv_quant._asdict(),
         dtype=str(cfg.dtype), batch=B, max_len=S,
         num_params=tfm.num_params(cfg),
         cuts=dict(prompt=PROMPT_LEN, prefill_of=S,
                   codebooks=f"PQ.fit per layer on the prompt's K·R, V·R, "
                             f"{FIT_ITERS} iterations",
                   tiled=[PROMPT_LEN, S - DECODE_TOKENS - 1],
                   decode_tokens=DECODE_TOKENS, weights="seeded init"),
         tokens=out_tokens, step_host_ms=host_ms,
         step_host_ms_median=statistics.median(host_ms),
         layer_device_ms=split,
         layer_device_ms_total=sum(v for k, v in split.items()
                                   if k != "head"),
         attention_vs_dense=dict(max_abs_err=attn_err, rel=attn_rel),
         pq_vs_dense=dict(max_len=short, top1_agree=agree,
                          max_logit_gap=gaps),
         cache_bytes=cache_bytes, dense_bf16_cache_bytes=dense_bytes,
         seconds=secs, launches=launches, launches_by_part=counts,
         peak_memory_bytes=peaks, total_s=time.perf_counter() - t_all,
         card=smi)
    for name in DECODE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the decode path")
    lut, codes = seen["adc_batch"]
    del params, cache, seen
    return dict(launches=launches, main_launches=counts["decode"], lut=lut,
                codes=codes)


def phase_decode_kernels(ctx: dict) -> dict:
    """adc_batch against its plain version on the decode's operands and on
    other geometries, timed beside its bound and a library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    lut, codes = ctx["lut"].contiguous(), ctx["codes"]
    dev = codes.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)

    def random_case(groups, r, Dp, S):
        return (torch.randn((groups, r, Dp, 256), generator=g, device=dev),
                torch.randint(0, 256, (groups, S, Dp), generator=g,
                              device=dev, dtype=torch.uint8))

    cases = {"decode": (lut, codes),
             "nemotron_r12_dp24": random_case(8, 12, 24, 65_537),
             "dp16_r3_ragged": random_case(5, 3, 16, 100_003)}
    errs = {}
    for name, (lt, cd) in cases.items():
        for dt, (lv, sc) in _lut_variants(lt).items():
            got = ops.adc_batch(lv, cd, sc)
            want = ref.adc_batch_ref(lv, cd, sc)
            torch.cuda.synchronize()
            if dt == "float32":
                check(torch.equal(got, want), f"adc_batch {name} float32 is "
                      "not bit-equal to its plain version")
                errs[f"adc_batch/{name}/{dt}"] = 0.0
            else:
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                check(rel <= BATCH_RTOL, f"adc_batch {name} {dt}: relative "
                      f"error {rel}")
                errs[f"adc_batch/{name}/{dt}"] = err
            del got, want
    gq, r, Dp, K = lut.shape
    S = codes.shape[1]
    k_ms = graph_ms(lambda: ops.adc_batch(lut, codes), launches=20)
    p_ms = graph_ms(lambda: ref.adc_batch_ref(lut, codes), launches=2)
    # the library yardstick: one embedding_bag, each (group, row) a bag of
    # its Dp entries of a (g·Dp·K, r) table, the group's offset g·Dp·K
    # added to its codes; the int32 index tensor is made outside the call
    offs = (torch.arange(gq, device=dev, dtype=torch.int32)[:, None, None]
            * (Dp * K)
            + torch.arange(Dp, device=dev, dtype=torch.int32) * K)
    bag = (codes.int() + offs).reshape(gq * S, Dp)
    table = lut.permute(0, 2, 3, 1).reshape(gq * Dp * K, r).contiguous()
    lib = functools.partial(F.embedding_bag, bag, table, mode="sum")
    want = ref.adc_batch_ref(lut, codes)
    lib_err = float((lib().reshape(gq, S, r).permute(0, 2, 1) - want).abs()
                    .max()) / float(want.abs().max())
    check(lib_err <= BATCH_RTOL, f"library yardstick computes another "
          f"function (relative error {lib_err})")
    del want
    lib_ms = graph_ms(lib, launches=5)
    del bag, table, lib, offs
    extra = {}
    for dt in ("int8", "uint8"):
        lv, sc = ops.quantize_luts(lut, dt)
        extra[f"{dt}_ms"] = graph_ms(lambda: ops.adc_batch(lv, codes, sc),
                                     launches=20)
    lt, cd = cases["nemotron_r12_dp24"]
    extra["nemotron_r12_dp24"] = dict(
        shape=dict(g=lt.shape[0], r=lt.shape[1], Dp=lt.shape[2],
                   S=cd.shape[1]),
        ms=graph_ms(lambda: ops.adc_batch(lt, cd), launches=20))
    nbytes = codes.numel() + gq * r * S * 4 + lut.numel() * 4
    flops = gq * r * S * Dp
    rows = {"adc_batch": dict(
        shape=dict(g=gq, r=r, Dp=Dp, K=K, S=S), ms=k_ms, plain_ms=p_ms,
        bytes=nbytes, flops=flops, **_bound(nbytes, flops),
        library_ms=lib_ms,
        max_abs_err=max(v for key, v in errs.items()))}
    emit("decode_kernels", max_abs_err=errs, kernels=rows, extra=extra,
         launches=ctx["launches"], card=torch.cuda.get_device_name(0))
    return rows, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    ctx = phase_main(smi)
    rows, errs = phase_kernels(ctx)
    launches = {k: ctx["launches"][k] for k in SOURCES}
    engine_rows, engine_errs, engine_launches = phase_engine(ctx, smi)
    rows.update(engine_rows)
    errs.update(engine_errs)
    launches["fused_lut"] = engine_launches["fused_lut"]
    del ctx                          # frees the 1M-row index
    torch.cuda.empty_cache()
    tctx = phase_train(smi)
    train_rows, train_errs = phase_train_kernels(tctx)
    rows.update(train_rows)
    errs.update(train_errs)
    launches.update({k: tctx["launches"][k] for k in NEW_KERNELS})
    del tctx                         # frees the two-tower model
    torch.cuda.empty_cache()
    dctx = phase_decode(smi)
    decode_rows, decode_errs = phase_decode_kernels(dctx)
    rows.update(decode_rows)
    errs.update(decode_errs)
    launches["adc_batch"] = dctx["main_launches"]["adc_batch"]
    del dctx
    summary = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(v for key, v in errs.items()
                            if key.startswith(name + "/")),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
