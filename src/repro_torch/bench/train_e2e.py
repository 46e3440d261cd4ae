"""Overlapped end-to-end training: rotation learning with a live index
(port of ``benchmarks/train_e2e.py``, single device).

A GCD trainer minimizes PQ distortion through the rotation (plus a fixed
tanh tower term that makes the step compute-bound) while a live ``ivf``
Engine serves recall probes and a balanced churn stream mutates the
corpus. Three arms run the same batches, deltas and churn schedule:

  * ``bare``: the trainer and the prefetching pipeline alone;
  * ``bg``: the overlapped runtime: ``LiveIndexLoop`` replays each step's
    ``RotationDelta`` onto the Engine every ``refresh_every`` steps, churn
    rides a ``ChurnController``, and a ``BackgroundCompactor`` repacks and
    re-encodes the stalest rows on a worker thread;
  * ``sync``: the same, but the compaction (with the same re-encode)
    runs on the training thread at the same cadence.

A fourth, replayed arm (``rebuild``) applies the same deltas and churn to
a twin state and re-encodes every live row each refresh round: the
freshness oracle the staleness machinery must match.

The checks are the JAX script's (``benchmarks/train_e2e.py:376-384``):
``live_step_overhead_ok`` (the bg arm's median step ≤ 1.15× the bare
arm's), ``bg_p99_below_sync``, ``zero_steady_recompiles`` (on the port: no
new Engine executable after the warm-up, and every state shape and
``max_blocks`` unchanged), ``recall_matches_rebuild`` (mean recall@10
against exact within 0.01 of the rebuild arm's), ``background_ran``,
``prefetch_effective`` and ``training_converged``.

The live set is a mask over one tensor of vectors (``pool``: the corpus,
then the add stream; row = item id), and the probes' exact top-10 is
computed on the device, so the loop scales to a 1M-row index.

    PYTHONPATH=src python -m repro_torch.bench.train_e2e [--fast] [--device cpu]

prints one JSON line of results, one of checks, and the device; it exits
1 when a check fails and writes no file.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import numpy as np
import torch

from repro_torch import churn, rotations, search
from repro_torch import device as _device
from repro_torch.bench import common
from repro_torch.bench.churn import exact_top10, state_shapes
from repro_torch.churn import ops as churn_ops
from repro_torch.core import givens
from repro_torch.data import pipeline as pipe_lib
from repro_torch.data import synthetic
from repro_torch.index import ivf as index_ivf
from repro_torch.metrics import recall_at_k
from repro_torch.pipeline import LiveIndexLoop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

FAST = dict(n=32000, dim=32, queries=64, lists=32, subspaces=8,
            codewords=32, steps=54, batch=8192, nprobe=8, refresh_every=6,
            compact_every=3, reencode_rows=2048, staging_rows=512,
            churn_batch=32, churn_every=3, warmup=12, probe_every=6)


def emit(name: str, **fields) -> None:
    common.emit("train_e2e", name, **fields)


def schedule(n: int, steps: int, churn_batch: int, churn_every: int):
    """The churn schedule every arm shares: per step None or (add_ids,
    dead_ids), int32 numpy, the removals drawn from the live set as it
    evolves (numpy's ``default_rng(0)``, as the JAX script draws them).
    The adds are rows n, n + 1, ... of the pool, their ids their rows."""
    rng = np.random.default_rng(0)
    live = np.zeros(n + (steps // max(churn_every, 1) + 1) * churn_batch,
                    dtype=bool)
    live[:n] = True
    next_id = n
    sched: list = []
    for s in range(steps):
        if churn_every <= 0 or (s + 1) % churn_every:
            sched.append(None)
            continue
        dead = rng.choice(np.nonzero(live)[0], size=churn_batch,
                          replace=False).astype(np.int32)
        add_ids = np.arange(next_id, next_id + churn_batch, dtype=np.int32)
        next_id += churn_batch
        live[dead] = False
        live[add_ids] = True
        sched.append((add_ids, dead))
    return sched


def live_ids(state) -> np.ndarray:
    """Every live id of an ADC state: CSR rows and staged rows."""
    ids = state.index.ids.cpu().numpy()
    out = [ids[ids >= 0]]
    if state.staging is not None:
        sid = state.staging.ids.cpu().numpy()
        out.append(sid[sid >= 0])
    return np.concatenate(out).astype(np.int64)


def _rows(pool: torch.Tensor, ids) -> torch.Tensor:
    return pool[torch.as_tensor(np.asarray(ids, dtype=np.int64),
                                device=pool.device)]


def _tower(seed: int, dim: int, dev: torch.device):
    """The fixed encoder tower (W1 (dim, 8·dim), W2 (8·dim, dim))."""
    w1 = torch.randn((dim, 8 * dim), generator=_device.generator(seed + 2,
                                                                 dev),
                     device=dev) / math.sqrt(dim)
    w2 = torch.randn((8 * dim, dim), generator=_device.generator(seed + 3,
                                                                 dev),
                     device=dev) / math.sqrt(8 * dim)
    return w1, w2


def train_arm(mode: str, *, index0, pool, Q, live0: np.ndarray, sched,
              steps: int, batch: int, dim: int, nprobe: int,
              staging_rows: int, refresh_every: int, compact_every: int,
              reencode_rows: int, warmup: int, probe_every: int, seed: int,
              part=None):
    """One training run; ``mode`` is 'bare', 'bg' or 'sync' (module
    docstring). ``part(name)``, if given, is a context entered around each
    part of a step on this thread ("train_step", "churn", "refresh",
    "sync_compact", "probe"); the caller can count launches by it.
    Returns the arm's measurements."""
    part = part or (lambda name: contextlib.nullcontext())
    dev = pool.device
    live = live0.copy()
    quantizer = index0.quantizer
    w1, w2 = _tower(seed, dim, dev)

    def batch_fn(g):
        return (synthetic.sift_like(g, batch, dim, device=dev),)

    # quantization-aware loss with a fixed encoder tower: the tower term
    # makes the step compute-bound (a bare distortion on a small batch is
    # almost free, which would let any host-side runtime pass the 1.15×
    # overhead check and hide nothing)
    def loss_fn(p, x):
        xr = x @ p["R"]
        h = torch.tanh(xr @ w1) @ w2
        return (quantizer.distortion(xr)
                + 1e-2 * torch.mean(torch.sum((xr - h) ** 2, dim=-1)))

    ocfg = opt_lib.OptimizerConfig(
        lr=1e-2, total_steps=steps, warmup_steps=1, schedule="constant",
        rotation=rotations.RotationConfig.from_spec("gcd_greedy"))
    params = {"R": index0.R.clone().requires_grad_(True)}
    tstate = ts.init_state(_device.generator(seed + 1, dev), params, ocfg)
    step_fn = ts.make_train_step(loss_fn, ocfg, emit_deltas=mode != "bare")
    pipe = pipe_lib.Pipeline(batch_fn, seed=seed, prefetch=True, device=dev)

    eng = tracker = comp = ctl = loop = None
    compact_period = refresh_every * compact_every
    if mode != "bare":
        state = search.IVF.attach(index0, nprobe=nprobe)
        eng = search.Engine(search.make("ivf"), state, k=10, nprobe=nprobe,
                            min_bucket=Q.shape[0])
        tracker = churn.StalenessTracker(np.nonzero(live)[0])
        if mode == "bg":
            comp = churn.BackgroundCompactor(
                eng, tracker=tracker, reencode_fn=lambda i: _rows(pool, i),
                reencode_rows=reencode_rows)
        ctl = churn.ChurnController(eng, staging_rows=staging_rows,
                                    flush_at=0.5, compact_at=10.0,
                                    compactor=comp)
        loop = LiveIndexLoop(eng, refresh_every=refresh_every,
                             tracker=tracker, compactor=comp,
                             compact_every=compact_every)
        with part("probe"):
            eng.search(Q)              # the first search, with staging in

    times: list[float] = []
    deltas: list = []
    probes: list[dict] = []
    warm = None
    t_start = time.perf_counter()
    for s in range(steps):
        entry = sched[s]
        t0 = time.perf_counter()
        with part("train_step"):
            bdata = next(pipe)
            tstate, metrics = step_fn(tstate, *bdata)
            loss = float(metrics["loss"])     # the step really finished
        if mode != "bare":
            with part("churn"):
                if entry is not None:
                    add_ids, dead = entry
                    ctl.step(add=_rows(pool, add_ids), add_ids=add_ids,
                             remove_ids=dead)
                    tracker.record(add_ids)
                    tracker.forget(dead)
                else:
                    ctl.poll_background()
            with part("refresh"):
                loop.on_step(metrics)
            if mode == "sync" and (s + 1) % compact_period == 0:
                # the baseline: the same repack and staleness re-encode,
                # on the training thread
                with part("sync_compact"):
                    rid = tracker.stalest(reencode_rows)
                    re = (rid, _rows(pool, rid)) if rid.size else None
                    eng.state = churn_ops.compact(
                        eng.state, include_staged=False, reencode=re)
                    common.sync(dev)
                    if rid.size:
                        tracker.record(rid)
        times.append(time.perf_counter() - t0)

        # ---- untimed bookkeeping and probes ------------------------------
        if mode != "bare":
            deltas.append(metrics["rotation_deltas"]["R"])
        if entry is not None:
            live[entry[1]] = False
            live[entry[0]] = True
        if mode != "bare" and (s + 1) % probe_every == 0:
            with part("probe"):
                truth = exact_top10(Q, pool, live)
                res = eng.search(Q)
            probes.append(dict(step=s + 1,
                               wall_s=time.perf_counter() - t_start,
                               recall=recall_at_k(res.ids, truth)))
        if mode != "bare" and s + 1 == warmup:
            es = eng.stats()
            warm = dict(compiles=es["compiles"],
                        executables=es["executables"],
                        shapes=state_shapes(eng.state))

    tail = times[warmup:] or times
    out = dict(
        mode=mode,
        step_ms_p50=float(np.median(tail) * 1e3),
        step_ms_p99=float(np.percentile(tail, 99) * 1e3),
        step_ms_max=float(np.max(tail) * 1e3),
        step_ms=[t * 1e3 for t in times],
        loss_final=loss,
        R_final=tstate.params["R"].detach(),
        prefetch_hits=pipe.prefetch_hits,
        prefetch_misses=pipe.prefetch_misses,
        probes=probes,
    )
    if mode != "bare":
        loop.drain()
        es = eng.stats()
        warm = warm or dict(compiles=es["compiles"],
                            executables=es["executables"],
                            shapes=state_shapes(eng.state))
        out.update(
            recompiles_steady=int(es["compiles"] - warm["compiles"]
                                  + es["executables"] - warm["executables"]),
            shapes_steady=state_shapes(eng.state) == warm["shapes"],
            shapes_warm=warm["shapes"],
            lut_invalidations=int(es["lut_invalidations"]),
            churn={k: es["churn"][k] for k in (
                "bg_submitted", "bg_compactions", "bg_discarded",
                "flushes_deferred", "reencoded", "flushes", "staged",
                "tombstoned")},
            compact_hidden_ms=es["churn"]["compact_hidden_ms_total"],
            staleness_hist={str(k): v for k, v in
                            sorted(tracker.histogram().items())},
            loop=loop.stats(),
            deltas=deltas,
            final_live=live,
        )
        if comp is not None:
            comp.close()
    pipe.close()
    return out


def rebuild_arm(*, index0, pool, Q, live0: np.ndarray, sched, deltas,
                steps: int, nprobe: int, staging_rows: int,
                refresh_every: int, probe_every: int):
    """The freshness oracle: the same deltas and churn, but every live row
    re-encoded against the current quantizers each refresh round, replayed
    with no trainer. Returns the probes."""
    live = live0.copy()
    searcher = search.make("ivf")
    state = churn_ops.with_staging(search.IVF.attach(index0, nprobe=nprobe),
                                   staging_rows)
    probes: list[dict] = []
    for s in range(steps):
        entry = sched[s]
        if entry is not None:
            add_ids, dead = entry
            state = churn_ops.tombstone(state, dead)
            if churn_ops.free_slots(state) < len(add_ids):
                state, _ = churn_ops.flush(state)
            if churn_ops.free_slots(state) < len(add_ids):
                state = churn_ops.compact(state)
            state = churn_ops.stage(state, _rows(pool, add_ids), add_ids)
            live[dead] = False
            live[add_ids] = True
        if (s + 1) % refresh_every == 0:
            for d in deltas[s + 1 - refresh_every:s + 1]:
                state = searcher.refresh(state, d)
            ids = live_ids(state)
            state = churn_ops.compact(state, include_staged=True,
                                      reencode=(ids, _rows(pool, ids)))
        if (s + 1) % probe_every == 0:
            truth = exact_top10(Q, pool, live)
            res = searcher.search(state, Q, k=10, nprobe=nprobe)
            probes.append(dict(step=s + 1,
                               recall=recall_at_k(res.ids, truth)))
    return probes


def checks_of(bare: dict, bg: dict, sync: dict, rebuild_probes: list,
              reencode_rows: int) -> tuple[dict, dict]:
    """(results, the JAX script's seven checks) of the four arms."""
    recall_live = [p["recall"] for p in bg["probes"]]
    recall_rebuild = [p["recall"] for p in rebuild_probes]
    recall_gap = float(abs(np.mean(recall_live) - np.mean(recall_rebuild)))
    overhead = bg["step_ms_p50"] / max(bare["step_ms_p50"], 1e-9)
    ch = bg["churn"]
    results = dict(
        bare_step_ms_p50=bare["step_ms_p50"],
        bare_step_ms_p99=bare["step_ms_p99"],
        live_step_ms_p50=bg["step_ms_p50"],
        overhead_ratio=float(overhead),
        bg_step_ms_p99=bg["step_ms_p99"],
        sync_step_ms_p50=sync["step_ms_p50"],
        sync_step_ms_p99=sync["step_ms_p99"],
        bg_step_ms_max=bg["step_ms_max"],
        sync_step_ms_max=sync["step_ms_max"],
        recompiles_steady=bg["recompiles_steady"],
        shapes_steady=bg["shapes_steady"],
        recall_live_mean=float(np.mean(recall_live)),
        recall_rebuild_mean=float(np.mean(recall_rebuild)),
        recall_gap=recall_gap,
        recall_trajectory=bg["probes"],
        recall_rebuild_trajectory=rebuild_probes,
        prefetch_hits=bg["prefetch_hits"],
        prefetch_misses=bg["prefetch_misses"],
        compact_hidden_ms=bg["compact_hidden_ms"],
        staleness_hist=bg["staleness_hist"],
        loop=bg["loop"],
        loss_bare=bare["loss_final"], loss_live=bg["loss_final"],
        **ch)
    checks = dict(
        live_step_overhead_ok=overhead <= 1.15,
        bg_p99_below_sync=bg["step_ms_p99"] < sync["step_ms_p99"],
        zero_steady_recompiles=(bg["recompiles_steady"] == 0
                                and bg["shapes_steady"]),
        recall_matches_rebuild=recall_gap <= 0.01,
        background_ran=(ch["bg_compactions"] >= 1
                        and ch["reencoded"] >= reencode_rows),
        prefetch_effective=bg["prefetch_hits"] > bg["prefetch_misses"],
        training_converged=bg["loss_final"] <= bare["loss_final"] * 1.001,
    )
    return results, checks


def setup(n: int, dim: int, queries: int, lists: int, subspaces: int,
          codewords: int, nprobe: int, steps: int, churn_batch: int,
          churn_every: int, device=None):
    """The corpus and the add stream (one ``sift_like`` draw, row = id), the
    queries, a random rotation and the IVF index built on it, as the JAX
    script makes them from seeds 0-3."""
    dev = _device.resolve(device)
    total_adds = (steps // max(churn_every, 1) + 1) * churn_batch
    pool = synthetic.sift_like(_device.generator(0, dev), n + total_adds,
                               dim, device=dev)
    Q = synthetic.sift_like(_device.generator(1, dev), queries, dim,
                            device=dev)
    R0 = givens.random_rotation(_device.generator(2, dev), dim, device=dev)
    cfg = search.SearchConfig(num_lists=lists, subspaces=subspaces,
                              codewords=codewords, nprobe=nprobe,
                              train_size=min(n, 16384))
    index0 = index_ivf.build(_device.generator(3, dev), pool[:n], R0,
                             cfg.ivf_config(), train_size=cfg.train_size,
                             device=dev)
    return pool, Q, index0


def run(n: int = 40_000, dim: int = 64, queries: int = 128, lists: int = 64,
        subspaces: int = 16, codewords: int = 64, steps: int = 120,
        batch: int = 2048, nprobe: int = 16, refresh_every: int = 8,
        compact_every: int = 2, reencode_rows: int = 2048,
        staging_rows: int = 1024, churn_batch: int = 64,
        churn_every: int = 2, warmup: int = 34, probe_every: int = 12,
        verbose: bool = True, device=None):
    """The overlapped-training benchmark -> (results, checks), on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    pool, Q, index0 = setup(n, dim, queries, lists, subspaces, codewords,
                            nprobe, steps, churn_batch, churn_every, dev)
    build_s = time.perf_counter() - t0
    live0 = np.zeros(pool.shape[0], dtype=bool)
    live0[:n] = True
    sched = schedule(n, steps, churn_batch, churn_every)
    kw = dict(index0=index0, pool=pool, Q=Q, live0=live0, sched=sched,
              steps=steps, batch=batch, dim=dim, nprobe=nprobe,
              staging_rows=staging_rows, refresh_every=refresh_every,
              compact_every=compact_every, reencode_rows=reencode_rows,
              warmup=warmup, probe_every=probe_every, seed=7)
    bare = train_arm("bare", **kw)
    bg = train_arm("bg", **kw)
    sync = train_arm("sync", **kw)
    rebuild_probes = rebuild_arm(
        index0=index0, pool=pool, Q=Q, live0=live0, sched=sched,
        deltas=bg["deltas"], steps=steps, nprobe=nprobe,
        staging_rows=staging_rows, refresh_every=refresh_every,
        probe_every=probe_every)
    results, checks = checks_of(bare, bg, sync, rebuild_probes,
                                reencode_rows)
    results["build_s"] = build_s
    if verbose:
        emit("results", **results)
        emit("checks", passed=all(checks.values()), **checks)
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--fast", action="store_true",
                    help="the JAX script's --fast sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(n=args.n, dim=args.dim, steps=args.steps, batch=args.batch)
    if args.fast:
        kw = dict(FAST)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, checks = run(device=dev, **kw)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
