"""The grid's dry run on one card (port of ``repro/launch/dryrun.py``).

For every (architecture × shape) cell the JAX dry run lowers and compiles
the real step against a production mesh and reads XLA's memory and cost
analyses. PyTorch has no compile step to ask; the counterpart of "lower
and compile" is to run the cell. ``run_cell`` builds the cell
(``launch.cells.build_cell``), runs its step or serve call on the card and
records, under the JAX record's keys:

  * ``flops_per_device`` — ``torch.utils.flop_counter.FlopCounterMode``
    around one call, plus the closed-form FLOPs of each hand-written kernel
    the call launched (its launch counter × its operands' shapes,
    ``roofline.analysis.kernel_flops``): FlopCounterMode does not see a
    ctypes kernel. It counts matrix products and attention only, not
    elementwise work, which XLA's ``cost_analysis`` counts: the two
    packages' ``useful_compute_ratio`` are not the same quantity. Under
    remat the recomputed forward is counted, as XLA counts it (≈ 0.75 for
    an LM train cell);
  * ``memory.peak_bytes`` — ``torch.cuda.max_memory_allocated`` over warm
    calls after ``reset_peak_memory_stats`` (on the CPU: the reckoning);
  * ``bytes_per_device`` — the closed-form reckoning's bytes moved a step
    (parameters, gradients, optimizer state, cache, saved activations).
    Torch has no bytes-accessed count;
  * ``step_s`` — one step or call, measured or extrapolated; ``fits_hbm``
    — the peak against the card's 80 GB.

A cell whose reckoned peak does not fit the card whole is measured at two
depths that keep the architecture's interleave (layers 1 and 2; 2 and 4 at
``moe_every`` = 2) at its own (micro)batch, and extrapolated linearly in
depth (the intercept carries the embeddings, the head and the chunked
cross-entropy). Where that does not fit either, at two cut batches too
(tokens a multiple of 8,192 for a train cell), fitted bilinearly. An LM
train cell runs its step at accumulation 2 (1 where 2 does not fit) and
counts a step as the optimizer plus A microbatches; at full depth it first
tries the largest even microbatch that fits with the cell's own
accumulation (olmo-1b × train_4k, three steps timed). Where no run fits,
the record holds the reckoning alone. Every cut is named in ``reduced``;
``measured_at`` lists each run's depth, batch and accumulation. Widths and
shapes are never changed. ``mesh`` is "1xH100", ``n_chips`` 1,
``collective_bytes`` 0 and ``loop_trips`` 1.0: the port counts by
running, not per loop body.

Every record also carries ``production_mesh``: for the JAX meshes
``16x16`` and ``2x16x16``, the full cell's ``sharding_warnings`` (the
rule resolution's, ``sorted(set(pop_warnings()))`` as the JAX record
has them) and ``argument_bytes``, one device's bytes of the cell's
arguments under its specs (``cells.argument_bytes``; XLA's count leaves
out an argument the step never reads, such as a serve cell's labels).
Both are reckoned from the specs on an ``AbstractMesh``, ``"from":
"reckoned"``: nothing runs on 256 chips. ``--production`` prints these
entries alone, without running any cell.

Usage (the records go to ``--out`` only; without it the run prints):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k [--out DIR] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --production
On ``--device cpu`` each cell runs at its architecture's ``make_smoke``
config and ``cells.SMOKE_SHAPES``' sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.launch import cells as cells_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.roofline import analysis
from repro_torch.sharding import rules as sh

#: the share of the card's memory a plan's reckoned peak may take
PLAN_SHARE = 0.92
#: a train cell's tokens a microbatch stay a multiple of this
#: (``layers.softmax_xent_chunked``'s full-size chunk)
TOKEN_MULTIPLE = 8192
#: whole steps timed when an LM train cell runs at full depth (14d)
WHOLE_STEPS = 3
#: the plan of an LM train cell at full depth and a cut microbatch
FULL_DEPTH = "full depth"
#: a serve call is repeated until this many seconds have passed (or
#: SERVE_CALLS calls), and the median call kept
SERVE_SECONDS = 0.25
SERVE_CALLS = 10
SEED = 0


class Plan(NamedTuple):
    """The runs of one cell: every (depth, batch) pair, each at ``accum``
    microbatches (train) and timed over ``steps`` calls. ``None`` is the
    cell's own depth or batch."""
    depths: tuple
    batches: tuple
    accum: int
    steps: int = 1
    why: str = ""


# ---------------------------------------------------------------------------
# the closed-form reckoning
# ---------------------------------------------------------------------------

def _nbytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _largest_leaf(cfg) -> int:
    if isinstance(cfg, tfm.TransformerConfig):
        d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
        per = cfg.moe.num_experts * d * f if cfg.moe is not None else d * f
        return max(V * d, cfg.num_layers * per)
    if isinstance(cfg, recsys.WideDeepConfig):
        return cfg.total_vocab * cfg.embed_dim
    if isinstance(cfg, (recsys.TwoTowerConfig, recsys.MINDConfig,
                        recsys.DINConfig)):
        return cfg.item_vocab * cfg.embed_dim
    return cells_lib.num_params(cfg)


def _table_params(cfg) -> int:
    """A recommender's embedding-table parameters (a gather reads a few
    rows of them)."""
    if isinstance(cfg, recsys.WideDeepConfig):
        return cfg.total_vocab * (cfg.embed_dim + 1)
    if isinstance(cfg, (recsys.TwoTowerConfig, recsys.MINDConfig,
                        recsys.DINConfig)):
        return cfg.item_vocab * cfg.embed_dim
    return 0


def _lm_activations(cfg, b: int, S: int, train: bool) -> dict:
    """Bytes of an LM's live activations at b sequences of S tokens."""
    T = b * S
    ab = _nbytes(cfg.dtype)
    d, hd = cfg.d_model, cfg.head_dim
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    mats = 3 if cfg.use_glu else 2
    if cfg.moe is not None:
        m = cfg.moe
        t = min(T, cfg.moe_chunk) if (cfg.moe_chunk and not train) else T
        ffn = t * m.top_k * m.capacity_factor * (mats * cfg.d_ff + 2 * d)
    else:
        ffn = T * mats * cfg.d_ff
    layer = (T * (4 * d + 2 * qkv) + ffn) * ab * (2 if train else 1)
    attn = b * cfg.num_heads * cfg.q_chunk * S * 4 * (3 if train else 2)
    out = dict(layer=layer, attention_chunk=attn, embeddings=T * d * ab * 2)
    if train:
        out["saved_layer_inputs"] = cfg.num_layers * T * d * ab
        out["cross_entropy"] = (min(T, cfg.xent_chunk) * cfg.vocab_size * 4
                                * 3 + T * d * 4)
    else:
        out["logits"] = b * cfg.vocab_size * 4
    return out


def reckon(cell, cfg, batch: int, accum: int) -> dict:
    """Closed-form memory of one run of ``cell`` at ``cfg``'s depth,
    ``batch`` and ``accum``: ``terms`` (bytes by name), ``peak_bytes`` (their
    sum) and ``moved_bytes`` (what a step or call reads and writes once:
    the roofline's bytes). An estimate for planning and for the record
    beside the measured peak, not a bound."""
    meta = cell.meta
    kind = meta["kind"]
    P = cells_lib.num_params(cfg)
    pb = _nbytes(getattr(cfg, "param_dtype", torch.float32))
    terms = {"params": P * pb}
    moved = 0.0
    if isinstance(cfg, tfm.TransformerConfig):
        S = meta["seq_len"]
        L, Hkv = cfg.num_layers, cfg.num_kv_heads
        if kind == "train":
            ocfg = cells_lib._opt_cfg_for(meta["cfg"])
            acts = _lm_activations(cfg, batch, S, True)
            terms["grads"] = P * pb
            if accum > 1:
                terms["accumulation"] = P * _nbytes(ocfg.accum_dtype)
            if ocfg.name == "adamw":
                terms["moments"] = 2 * P * _nbytes(ocfg.moment_dtype)
                terms["update_temporaries"] = 3 * _largest_leaf(cfg) * 4
            else:
                terms["update_temporaries"] = 4 * (1 << 27) * 4
            terms.update(acts)
            opt = P * (2 * pb + pb + 4 * _nbytes(ocfg.moment_dtype))
            micro = (P * pb * (3 if cfg.remat else 2) + 2 * P * pb
                     + 2 * acts["saved_layer_inputs"])
            moved = accum * micro + opt
        else:
            e, cb = ((cfg.kv_quant.num_subspaces, 1)
                     if cfg.kv_quant is not None
                     else (cfg.head_dim, _nbytes(cfg.dtype)))
            terms["cache"] = 2 * L * batch * Hkv * S * e * cb
            if kind == "prefill":
                terms.update(_lm_activations(cfg, batch, S, False))
                moved = (P * pb + terms["cache"]
                         + 4 * batch * S * cfg.d_model * _nbytes(cfg.dtype)
                         * L)
            else:
                terms["scores"] = 3 * batch * cfg.num_heads * S * 4
                moved = P * pb + terms["cache"]
    elif meta["family"] == "gnn":
        F, h = meta["shape_params"]["d_feat"], cfg.d_hidden
        terms["grads_moments"] = 3 * P * pb
        kindp = meta["shape_kind"]
        if kindp == "gnn_minibatch":
            f1, f2 = meta["shape_params"]["fanout"]
            rows = batch * (1 + f1 + f1 * f2)
            terms["blocks"] = rows * F * 4
            terms["layers"] = 3 * batch * (1 + f1) * (F + h) * 4
            moved = terms["blocks"] + terms["layers"] + 6 * P * pb
        else:
            if kindp == "gnn_graph_batch":
                n = batch * meta["shape_params"]["n_nodes"]
                E = batch * meta["shape_params"]["n_edges"]
            else:
                n = batch
                E = round(meta["edges"] * batch / meta["batch"])
            # the blocked aggregation (``gnn.aggregate``): the edge list,
            # its dst order and the transposed order (E int64 each, one
            # more while sorting), one block of messages and its reduce
            # at a time; each layer's (n, h) activations saved
            terms["features"] = n * F * 4
            terms["edges"] = 5 * E * 8
            terms["messages"] = 2 * min(E * max(F, h),
                                        gnn.CSR_BLOCK_ELEMS) * 4
            terms["nodes"] = 10 * n * h * 4
            moved = (sum(terms.values()) - terms["params"]
                     - terms["messages"] + 3 * E * (F + h) * 4 + 6 * P * pb)
    else:
        table = _table_params(cfg)
        dense = P - table
        e = cfg.embed_dim
        if isinstance(cfg, recsys.WideDeepConfig):
            rows_read = batch * cfg.n_sparse * (e + 1)
            act = batch * (cfg.n_sparse * e + sum(cfg.mlp_dims)) * 4
        elif isinstance(cfg, recsys.TwoTowerConfig):
            rows_read = batch * (cfg.hist_len + 1) * e
            act = batch * (cfg.hist_len * e + 2 * sum(cfg.tower_dims)) * 4
            if kind == "train":
                act += 4 * batch * batch * 4           # the (B, B) hinge
        elif isinstance(cfg, recsys.MINDConfig):
            rows_read = batch * (cfg.hist_len + 1) * e
            act = batch * cfg.hist_len * (2 * e + cfg.n_interests) * 4 * 3
            if kind == "train":
                act += 3 * batch * cfg.n_interests * batch * 4
        else:
            rows_read = batch * (cfg.hist_len + 1) * e
            act = (batch * cfg.hist_len * (5 * e + sum(cfg.attn_dims)) * 4
                   * 2)
        if kind == "retrieval":
            if isinstance(cfg, recsys.TwoTowerConfig):
                act = batch * (cfg.index.num_subspaces + 4)
                rows_read = cfg.hist_len * e
            elif isinstance(cfg, recsys.MINDConfig):
                act = batch * (e + 2 * cfg.n_interests) * 4
                rows_read = cfg.hist_len * e
            elif isinstance(cfg, recsys.DINConfig):
                chunk = min(cells_lib.DIN_CHUNK, batch)
                act = (chunk * cfg.hist_len * (5 * e + sum(cfg.attn_dims))
                       * 4 * 2 + batch * 4)
                rows_read = batch * e
        terms["activations"] = act
        if kind == "train":
            terms["grads"] = P * pb                    # a dense table grad
            terms["moments"] = 2 * P * 4
            terms["update_temporaries"] = 2 * _largest_leaf(cfg) * 4
            moved = (dense * pb * 3 + rows_read * pb * 2 + act * 2
                     + P * (2 * pb + pb + 16))
        else:
            moved = dense * pb + rows_read * pb + act
    return dict(terms=terms, peak_bytes=float(sum(terms.values())),
                moved_bytes=float(moved))


# ---------------------------------------------------------------------------
# measuring one run
# ---------------------------------------------------------------------------

_KERNELS = ("gcd_score", "givens_rotate", "pq_assign", "embedding_bag",
            "adc_lookup", "adc_batch", "ivf_adc", "fused_lut")


@contextlib.contextmanager
def kernel_work(into: dict):
    """Inside the block, every launch of a hand-written kernel adds its
    closed-form FLOPs (``analysis.kernel_flops`` of its operands' shapes)
    to ``into["flops"]`` and one to ``into["launches"][name]``. A call
    counts only where its wrapper's launch counter moved: a CPU call runs
    the plain version, which FlopCounterMode sees itself."""
    from repro_torch.kernels import ops

    into.setdefault("flops", 0.0)
    into.setdefault("launches", {})
    real = {name: getattr(ops, name) for name in _KERNELS}

    def spy(name):
        fn = real[name]

        def wrapped(*args, **kwargs):
            before = ops.LAUNCHES[name]
            out = fn(*args, **kwargs)
            n = ops.LAUNCHES[name] - before
            if n:
                shapes = [tuple(a.shape) if torch.is_tensor(a) else None
                          for a in args]
                into["flops"] += n * analysis.kernel_flops(
                    name, shapes, kwargs.get("block_size", 128))
                into["launches"][name] = into["launches"].get(name, 0) + n
            return out
        return wrapped

    for name in _KERNELS:
        setattr(ops, name, spy(name))
    try:
        yield into
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


class _Marks:
    """The time at each of a train step's marks (CUDA events on the card,
    the host clock on the CPU): grads = start → "backward", optimizer =
    "backward" → the last mark."""

    def __init__(self, dev: torch.device):
        self.dev, self.at = dev, []

    def __call__(self, name: str) -> None:
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.at.append((name, ev))
        else:
            self.at.append((name, time.perf_counter()))

    def split_s(self) -> dict:
        def gap(a, b):
            return (a.elapsed_time(b) / 1e3 if self.dev.type == "cuda"
                    else b - a)
        t = dict(self.at)
        out = dict(grads_s=gap(t["start"], t["backward"]),
                   optimizer_s=gap(t["backward"], self.at[-1][1]))
        self.at = []
        return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def measure(cell, depth, batch: int, accum: int, dev: torch.device,
            steps: int = 1, seed: int = SEED) -> dict:
    """One run of ``cell`` at ``depth`` layers (None: the config's),
    ``batch`` and ``accum``: a warm call under FlopCounterMode (the kernels'
    closed forms added), then ``steps`` timed train steps, or serve calls
    until SERVE_SECONDS (at most SERVE_CALLS), between
    ``reset_peak_memory_stats`` and ``max_memory_allocated``. Train cells
    run under deterministic algorithms (the caller's mode restored).
    Returns the run's FLOPs, peak bytes, step seconds (median, and each
    step's; a train step also split into its microbatches and optimizer,
    and every step's loss, the warm one's first), launches a call and the
    calls made."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.bench import common

    meta = cell.meta
    cfg = cells_lib.at_depth(meta["cfg"], depth)
    train = meta["kind"] == "train"
    g = _device.generator(seed, dev)
    marks = _Marks(dev) if train else None
    fn = cell.fn(cfg, accum, marks=marks)
    mode = common.deterministic() if train else contextlib.nullcontext()
    with mode:
        args = cell.make_inputs(cfg, batch, g, dev, accum)
        state, rest = (args[0], args[1:]) if train else (None, args)

        def call():
            nonlocal state
            if train:
                marks("start")
                state, m = fn(state, *rest)
                return m["loss"]
            return fn(*rest)

        work: dict = {}
        _sync(dev)
        with FlopCounterMode(display=False) as counter, kernel_work(work):
            out = call()
        _sync(dev)
        if train:
            marks.split_s()
        flops = float(counter.get_total_flops()) + work["flops"]
        _check_finite(out, meta)
        losses = [float(out)] if train else []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times, splits = [], []
        while True:
            _sync(dev)
            t0 = time.perf_counter()
            out = call()
            _sync(dev)
            times.append(time.perf_counter() - t0)
            if train:
                splits.append(marks.split_s())
                losses.append(float(out))
            n = len(times)
            if train and n >= steps:
                break
            if not train and (n >= SERVE_CALLS
                              or (n >= steps and sum(times) >= SERVE_SECONDS)):
                break
        _check_finite(out, meta)
        peak = (float(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None)
        del args, state, rest, out
    _free(dev)
    point = dict(depth=cfg.num_layers if meta["depth"] else None,
                 batch=batch, accum=accum, flops=flops,
                 launches=work["launches"], calls=1 + len(times),
                 step_s=statistics.median(times), step_s_all=times,
                 peak_bytes=peak)
    if train:
        point["grads_s"] = statistics.median(s["grads_s"] for s in splits)
        point["optimizer_s"] = statistics.median(s["optimizer_s"]
                                                 for s in splits)
        point["micro_s"] = point["grads_s"] / accum
        point["micro_s_all"] = [x["grads_s"] / accum for x in splits]
        point["losses"] = losses
    return point


def _check_finite(out, meta) -> None:
    t = out[0] if isinstance(out, tuple) else out
    if not bool(torch.all(torch.isfinite(t.float()))):
        raise FloatingPointError(f"{meta['arch']} × {meta['shape']}: the "
                                 "output is not finite")


# ---------------------------------------------------------------------------
# plans and the fit
# ---------------------------------------------------------------------------

def cut_depths(cfg) -> tuple:
    """Two depths that keep the interleave: 1 and 2, or 2 and 4 at
    ``moe_every`` = 2."""
    return (2, 4) if getattr(cfg, "interleaved", False) else (1, 2)


def _batch_cuts(meta, batch: int) -> list:
    """Pairs of cut batches, largest first: halves of the cell's batch down
    to the least a run takes (a train cell's microbatch keeps its tokens a
    multiple of TOKEN_MULTIPLE)."""
    least = 1
    if meta["family"] == "lm" and meta["kind"] == "train":
        least = max(1, TOKEN_MULTIPLE // meta["seq_len"])
    out, b = [], batch // 2
    while b >= least and b // 2 >= least:
        out.append((b, b // 2))
        b //= 2
    if not out and batch > least:
        out.append((batch, least))
    return out


def plans(cell, budget: float) -> list:
    """The ladder of plans for ``cell``, most faithful first, each one whose
    reckoned peak fits ``budget`` at every run (a run out of memory moves
    the cell to the next): whole; (an LM train cell)
    full depth at the largest even microbatch that fits with the cell's
    accumulation (``FULL_DEPTH``, found by two probe runs); two depths at
    the cell's batch; two depths at each pair of cut batches, largest
    first. A train cell cut in depth or batch runs accumulation 2, or 1
    where 2 does not fit."""
    meta = cell.meta
    full, B, A = meta["cfg"], meta["batch"], meta["accum"]
    lm_train = meta["family"] == "lm" and meta["kind"] == "train"
    out = []

    def fits(depths, batches, accum) -> bool:
        return all(reckon(cell, cells_lib.at_depth(full, d), b,
                          accum)["peak_bytes"] <= budget
                   for d in depths for b in batches)

    if fits((None,), (B,), A):
        out.append(Plan((None,), (B,), A, WHOLE_STEPS if lm_train else 1,
                        "whole"))
    least = (max(2, TOKEN_MULTIPLE // meta["seq_len"]) if lm_train else 1)
    if lm_train and fits((None,), (least,), min(2, A)):
        out.append(Plan((None,), (), A, WHOLE_STEPS, FULL_DEPTH))
    accums = [a for a in ((1, 2) if A > 1 else (1,)) if a <= A]
    accums = accums[::-1] if lm_train else [A]
    ds = cut_depths(full) if meta["depth"] else (None,)
    if meta["depth"]:
        for a in accums:
            if fits(ds, (B,), a):
                out.append(Plan(ds, (B,), a, 1,
                                f"depths {ds} of {full.num_layers}"))
                break
    for b2 in _batch_cuts(meta, B):
        hit = next((a for a in accums if fits(ds, b2, a)), None)
        if hit is not None:
            out.append(Plan(ds, b2, hit, 1, f"batch {B} -> {b2}"
                            + (f", depths {ds}" if ds != (None,) else "")))
    return out


def largest_microbatch(cell, dev, budget: float, seed: int = SEED,
                       retries: int = 2) -> tuple[list, dict, list]:
    """An LM train cell at full depth: peaks at microbatches of ``least``
    and twice that (accumulation 2) fitted linearly, the largest even
    microbatch up to the cell's whose fitted peak fits ``budget``, and
    WHOLE_STEPS whole steps there at the cell's accumulation (two less
    sequences after an out-of-memory, ``retries`` times). Returns the runs
    the cell's numbers are fitted from (the probe at twice ``least`` and
    the whole steps), the whole steps' summary and the notes."""
    meta = cell.meta
    B, A, S = meta["batch"], meta["accum"], meta["seq_len"]
    least = max(2, TOKEN_MULTIPLE // S)
    a = min(2, A)
    p1 = measure(cell, None, least, a, dev, 1, seed)
    p2 = measure(cell, None, 2 * least, a, dev, 1, seed)
    slope = (p2["peak_bytes"] - p1["peak_bytes"]) / least
    m = B
    while m > 2 * least and p2["peak_bytes"] + slope * (m - 2 * least) > budget:
        m -= 2
    notes = [f"full depth: microbatch {B} -> {m} (peaks at {least} and "
             f"{2 * least} sequences, accumulation {a}, fitted linearly)"]
    while True:
        try:
            whole = measure(cell, None, m, A, dev, WHOLE_STEPS, seed)
            break
        except torch.OutOfMemoryError:
            if not retries or m - 2 <= 2 * least:
                raise
            retries -= 1
            notes.append(f"microbatch {m}: out of memory; {m - 2}")
            m -= 2
        _free(dev)
    summary = dict(microbatch=m, accum=A, steps_s=whole["step_s_all"],
                   step_s=whole["step_s"],
                   tokens_per_s=m * A * S / whole["step_s"],
                   micro_s=whole["micro_s"],
                   optimizer_s=whole["optimizer_s"],
                   peak_bytes=whole["peak_bytes"],
                   probes=[dict(batch=p["batch"], accum=p["accum"],
                                peak_bytes=p["peak_bytes"],
                                micro_s=p["micro_s"]) for p in (p1, p2)])
    if m < B:
        notes.append(f"the cell's microbatch {B} fitted linearly from "
                     f"{2 * least} and {m}")
        return [p2, whole], summary, notes
    return [whole], summary, notes


def extrapolate(points: list, key: str, depth: int | None, batch: int
                ) -> float:
    """``key`` at (depth, batch) from runs at one or two depths × one or
    two batches: linear in depth at each batch, then linear in batch
    (bilinear where both were cut; the value itself where neither)."""
    def line(xs, ys, x):
        if len(xs) == 1:
            return ys[0]
        (x0, x1), (y0, y1) = xs, ys
        return y0 + (y1 - y0) * (x - x0) / (x1 - x0)

    batches = sorted({p["batch"] for p in points})
    at_batch = []
    for b in batches:
        ps = sorted((p for p in points if p["batch"] == b),
                    key=lambda p: p["depth"] or 0)
        at_batch.append(line([p["depth"] for p in ps],
                             [p[key] for p in ps], depth))
    return line(batches, at_batch, batch)


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def _device_memory(dev) -> float:
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return analysis.CHIP_HBM_BYTES


def _budget(dev) -> float:
    """What a plan's peak may take: PLAN_SHARE of the card's 80 GB (or of
    its total memory, where that is less)."""
    return PLAN_SHARE * min(analysis.CHIP_HBM_BYTES, _device_memory(dev))


def _fitted_peak(cell, points: list) -> float:
    """The runs' peak fitted to the cell's depth and batch; runs at
    accumulation 1 of a cell that accumulates hold no accumulation buffer,
    so the reckoned one (the full config's parameters in the accumulation
    dtype) is added."""
    meta = cell.meta
    full, B, A = meta["cfg"], meta["batch"], meta["accum"]
    depth = full.num_layers if meta["depth"] else None
    peak = extrapolate(points, "peak_bytes", depth, B)
    if meta["kind"] == "train" and A > 1 and all(p["accum"] == 1
                                                 for p in points):
        peak += reckon(cell, full, B, A)["terms"].get("accumulation", 0.0)
    return peak


def _record(cell, points: list, dev, reduced: list,
            whole_steps: dict | None) -> dict:
    """The record's measured part from the plan's runs (or the reckoning
    alone)."""
    meta = cell.meta
    full, B, A = meta["cfg"], meta["batch"], meta["accum"]
    depth = full.num_layers if meta["depth"] else None
    rk = reckon(cell, full, B, A)
    train = meta["kind"] == "train"
    out = dict(reckoning={k: float(v) for k, v in rk["terms"].items()},
               reckoned_peak_bytes=rk["peak_bytes"],
               reckoned_moved_bytes=rk["moved_bytes"])
    if not points:
        out.update(flops=None, peak_bytes=rk["peak_bytes"], step_s=None,
                   peak_from="reckoning")
        return out
    flops_pts = [dict(p, flops_step=p["flops"] * (A / p["accum"]
                                                  if train else 1.0))
                 for p in points]
    flops = extrapolate(flops_pts, "flops_step", depth, B)
    if train:
        micro = extrapolate(points, "micro_s", depth, B)
        opt = extrapolate(points, "optimizer_s", depth, B)
        step = opt + A * micro
        out.update(micro_s=micro, optimizer_s=opt)
    else:
        step = extrapolate(points, "step_s", depth, B)
    if dev.type == "cuda":
        peak = _fitted_peak(cell, points)
        peak_from = ("measured" if all(p["batch"] == B and p["depth"]
                                        == depth for p in points)
                     else "extrapolated")
        if train and A > 1 and all(p["accum"] == 1 for p in points):
            reduced.append("peak: the accumulation buffer reckoned, not "
                           "measured (runs at accumulation 1)")
    else:
        peak, peak_from = rk["peak_bytes"], "reckoning"
    out.update(flops=flops, step_s=step, peak_bytes=peak,
               peak_from=peak_from)
    if whole_steps:
        out["whole_steps"] = whole_steps
    return out


def _whole_after_fit(cell, points: list, used: Plan, dev, seed: int,
                     reduced: list) -> tuple[list, Plan]:
    """Where the reckoning kept a cell from running whole but the cut runs'
    fitted peak fits PLAN_SHARE of the card, run it whole: the measurement
    replaces the fit (an out-of-memory keeps the fit, and says so)."""
    meta = cell.meta
    B, A = meta["batch"], meta["accum"]
    fit = _fitted_peak(cell, points)
    if fit > _budget(dev):
        return points, used
    lm_train = meta["family"] == "lm" and meta["kind"] == "train"
    whole = None
    try:
        whole = measure(cell, None, B, A, dev,
                        WHOLE_STEPS if lm_train else 1, seed)
    except torch.OutOfMemoryError as e:
        reduced.append(f"whole after the cut runs' fit ({fit / 1e9:.1f} GB):"
                       f" out of memory ({str(e).splitlines()[0][:120]})")
    if whole is None:
        _free(dev)
        return points, used
    reduced.append(f"measured whole: the reckoning did not fit, the cut "
                   f"runs' fit ({fit / 1e9:.1f} GB; {used.why}) did")
    return [whole], Plan((None,), (B,), A, 1, "whole")


def production_mesh(arch_id: str, shape_name: str) -> dict:
    """{mesh name: the full cell's sharding warnings and per-device
    argument bytes on that production mesh}, reckoned from its specs."""
    out = {}
    for multi_pod in (False, True):
        mesh = mesh_lib.abstract_production_mesh(multi_pod=multi_pod)
        sh.pop_warnings()
        cell = cells_lib.build_cell(arch_id, shape_name, mesh=mesh)
        out[mesh.name] = {
            "sharding_warnings": sorted(set(sh.pop_warnings())),
            "argument_bytes": cells_lib.argument_bytes(cell),
            "n_chips": analysis.num_chips(mesh), "from": "reckoned"}
    return out


def run_cell(arch_id: str, shape_name: str, *, device=None,
             out_dir: str | None = None, verbose: bool = True,
             plan: Plan | None = None, seed: int = SEED) -> dict:
    """Measure one cell on ``device`` (the card by default; on the CPU at
    its smoke config and sizes) and return its record; write it to
    ``out_dir`` as ``<arch>__<shape>__<mesh>.json`` when given. ``plan``
    replaces the ladder (``plans``) by one plan. A run that runs out of
    memory sends the cell to the next plan, and says so in ``reduced``;
    any other failure is the record's ``error`` (``ok`` false)."""
    dev = _device.resolve(device)
    mesh = mesh_lib.make_host_mesh(dev)
    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh.name,
           "ok": False}
    try:
        rec["production_mesh"] = production_mesh(arch_id, shape_name)
        smoke = dev.type != "cuda"
        cell = cells_lib.build_cell(arch_id, shape_name, smoke=smoke)
        meta = cell.meta
        full = meta["cfg"]
        reduced = (["smoke config and cells.SMOKE_SHAPES' sizes (CPU)"]
                   if smoke else [])
        ladder = [plan] if plan is not None else plans(cell, _budget(dev))
        points, used, whole_steps = [], None, None
        whole_oom = False
        for p in ladder:
            try:
                if p.why == FULL_DEPTH:
                    points, whole_steps, notes = largest_microbatch(
                        cell, dev, _budget(dev), seed)
                    reduced.extend(notes)
                else:
                    points = [measure(cell, d, b, p.accum, dev, p.steps,
                                      seed)
                              for b in p.batches for d in p.depths]
                used = p
                break
            except torch.OutOfMemoryError as e:
                reduced.append(f"{p.why}: out of memory "
                               f"({str(e).splitlines()[0][:120]})")
                whole_oom |= p.why == "whole"
                points = []
            # the failed run's frames are freed with its traceback, here
            _free(dev)
        if used is None:
            reduced.append("no run fits one card: the reckoning alone")
        elif (plan is None and dev.type == "cuda"
              and used.why not in ("whole", FULL_DEPTH)):
            n = len(reduced)
            points, used = _whole_after_fit(cell, points, used, dev, seed,
                                            reduced)
            whole_oom |= used.why != "whole" and len(reduced) > n
        if used is not None and used.why not in ("whole", FULL_DEPTH):
            reduced.append(used.why)
            if meta["kind"] == "train" and used.accum != meta["accum"]:
                reduced.append(f"accumulation {meta['accum']} -> "
                               f"{used.accum}: a step = optimizer + "
                               f"{meta['accum']} microbatches")
        part = _record(cell, points, dev, reduced, whole_steps)
        rk_peak = part["reckoned_peak_bytes"]
        flops = part["flops"]
        moved = part["reckoned_moved_bytes"]
        report = analysis.analyze(
            flops if flops is not None else meta["model_flops"], moved,
            part["peak_bytes"], meta["model_flops"],
            n_chips=analysis.num_chips(mesh),
            peak=analysis.peak_flops(getattr(full, "dtype", torch.float32)),
            hbm_limit=analysis.CHIP_HBM_BYTES)
        if flops is None:
            # no run: the compute term at the model's FLOPs, no ratio
            report["flops_from"] = "model_flops_total (no run)"
            report["useful_compute_ratio"] = None
        rec.update(
            ok=True, kind=meta["kind"], n_chips=analysis.num_chips(mesh),
            # a whole run out of memory outweighs a fit that says it fits
            fits_hbm=(not whole_oom
                      and part["peak_bytes"] <= analysis.CHIP_HBM_BYTES),
            report=report, step_s=part["step_s"],
            measured_at=points,
            reduced=reduced, peak_from=part["peak_from"],
            reckoning=part["reckoning"], reckoned_peak_bytes=rk_peak,
            cell=dict(batch=meta["batch"], batch_unit=meta["batch_unit"],
                      depth=meta["depth"], accum=meta["accum"],
                      optimizer=meta.get("optimizer")),
            device_memory_bytes=_device_memory(dev),
            seconds=round(time.time() - t0, 2))
        for k in ("micro_s", "optimizer_s", "whole_steps"):
            if k in part:
                rec[k] = part[k]
        if verbose:
            rep = report
            print(f"[{arch_id} × {shape_name} × {mesh.name}] OK "
                  f"{rec['seconds']}s step={rec['step_s']} "
                  f"peak={rep['memory']['peak_bytes'] / 1e9:.2f} GB "
                  f"({rec['peak_from']}; reckoned {rk_peak / 1e9:.2f} GB) "
                  f"fits={rec['fits_hbm']} flops={rep['flops_per_device']:.3e}"
                  f" model={rep.get('model_flops_total', 0):.3e} "
                  f"→ {rep['dominant']}-bound; reduced: {reduced}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — a failure is the cell's result
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{arch_id} × {shape_name} × {mesh.name}] FAIL: "
                  f"{rec['error']}", flush=True)
        _free(dev)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, record_name(rec) + ".json"),
                  "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def record_name(rec: dict) -> str:
    return f"{rec['arch']}__{rec['shape']}__{rec['mesh']}".replace("/", "_")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true", help="every grid cell")
    ap.add_argument("--out", default=None,
                    help="write each record here (default: print only)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (smoke configs)")
    ap.add_argument("--production", action="store_true",
                    help="print each cell's production-mesh entries "
                         "(reckoned) and run nothing")
    args = ap.parse_args(argv)

    from repro_torch import configs

    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    todo = configs.grid_cells() if args.all else [(args.arch, args.shape)]
    if args.production:
        for arch_id, shape_name in todo:
            print(json.dumps({"arch": arch_id, "shape": shape_name,
                              "production_mesh": production_mesh(
                                  arch_id, shape_name)}), flush=True)
        return 0

    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({
            "device": torch.cuda.get_device_name(dev),
            "total_memory_bytes": _device_memory(dev),
            "chip_hbm_bytes": analysis.CHIP_HBM_BYTES}), flush=True)
    mesh = mesh_lib.make_host_mesh(dev)
    n_ok = n_fail = n_skip = 0
    for arch_id, shape_name in todo:
        if args.skip_existing and args.out:
            path = os.path.join(args.out, record_name(
                dict(arch=arch_id, shape=shape_name, mesh=mesh.name))
                + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        n_skip += 1
                        continue
        rec = run_cell(arch_id, shape_name, device=dev, out_dir=args.out)
        n_ok += int(rec["ok"])
        n_fail += int(not rec["ok"])
    print(f"\ndry-run done: {n_ok} ok, {n_fail} failed, {n_skip} skipped",
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
