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
           mask, plus gcd_score at a ragged n = 200. Times per launch
           from a CUDA graph of back-to-back launches (device time, host
           enqueue left out) for each kernel, its plain version, its
           library yardstick and the launch floor; one-shot CUDA-event
           times with a cold L2 (host latency included); then the
           serve_p99 batch stage by stage.
Every check raises on failure, so the script exits non-zero with the error;
it also exits non-zero without a CUDA device. The last three lines are the
nvidia-smi line, the per-kernel JSON summary and the device JSON.
"""
from __future__ import annotations

import functools
import json
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
}


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


def _exact_topk(X, Q, k: int):
    """Exact MIPS ground truth, computed here with a chunked plain Q·Xᵀ."""
    import torch

    best_s = torch.full((Q.shape[0], k), float("-inf"), device=Q.device)
    best_i = torch.full((Q.shape[0], k), -1, dtype=torch.int64,
                        device=Q.device)
    step = 1 << 18
    for s in range(0, X.shape[0], step):
        sc = Q @ X[s:s + step].T
        cs = torch.cat([best_s, sc], dim=1)
        ci = torch.cat([best_i, torch.arange(
            s, s + sc.shape[1], device=Q.device).expand(Q.shape[0], -1)],
            dim=1)
        best_s, top = torch.topk(cs, k, dim=1)
        best_i = ci.gather(1, top)
    return best_i


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

    # ground truths: exact MIPS, and the flat ADC scan of the same codes
    truth = _exact_topk(X, Q, 10)
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
    R_before = state.index.R
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
         card=smi, exact_truth="chunked plain Q·Xᵀ top-10 in chip_smoke")
    check(mismatch_before == 0.0,
          f"stored codes differ from a re-encode before any refresh "
          f"({mismatch_before})")
    check(mismatch <= MISMATCH_LIMIT, f"refresh_mismatch {mismatch} after "
          "a subspace-GCD refresh")
    check(flips["max_rel_gap"] <= TIE_GAP, f"a refreshed code is stale, not "
          f"a float32 tie: {flips}")
    check(orth < 1e-5, f"orthogonality error {orth} after refresh")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return dict(launches=launches, index=state.index, Q=Q, G=G_sub,
                R=R_before.contiguous())


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

    for name in rows:
        rows[name]["max_abs_err"] = max(v for key, v in errs.items()
                                        if key.startswith(name + "/"))
    emit("kernels", max_abs_err=errs, kernels=rows,
         launches=ctx["launches"], one_shot_ms=one_shot,
         serve_p99_stage_ms=stage_ms, launch_floor_ms=launch_floor_ms,
         host_launch_ms=host_launch_ms,
         card=torch.cuda.get_device_name(0))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    ctx = phase_main(smi)
    rows = phase_kernels(ctx)
    summary = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=ctx["launches"][name], max_abs_err=r["max_abs_err"],
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
