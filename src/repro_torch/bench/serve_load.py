"""Open-loop Poisson load over the ``repro_torch.serve`` front end (port of
``benchmarks/serve_load.py``).

The serving claim: under Poisson arrivals near the top rung's capacity,
SLO-adaptive nprobe beats every fixed-nprobe baseline of equal or better
recall on p99 latency, with no new executable in steady state and no LUT
invalidation across namespaces.

Two namespaces (``alpha`` and ``beta``: their own corpora, R, 64-query
pools and exact top-10 truth; fused-refresh IVF; alpha also carries a
ChurnController whose idle-slot ticks run between buckets) are served by
one Frontend a cell. The cells are one fixed-nprobe cell a ladder rung
and the adaptive cell, and every cell replays the same arrival trace
(seeded Poisson gaps over the finite pools: repeats, as real traffic has,
which keep the LUT cache meaningful).

Time is virtual (``serve.VirtualClock``): queueing unfolds on the virtual
axis while each batch's service time is measured and folded in through
``advance``. The arrival rate is calibrated from throwaway adaptive
Frontends' warm-up models, ``load`` × the top rung's full-bucket
throughput, so "near capacity" means the same on any host. One departure
from the JAX script, which times one Frontend's warm-up: the port takes
the median top-rung time of ``CALIBRATIONS`` Frontends, so that one busy
moment of a shared host (a warm-up timed slow, then cells that see no
backlog, or timed fast, then cells with no idle slot) does not set the
rate.

During a run alpha absorbs a cross-subspace GCD delta every
``refresh_every`` arrivals (one fused refresh cannot keep LUTs through):
alpha's cache is invalidated, and the isolation check holds that beta's
never is. The first ``warm_frac`` of the completed tickets are left out;
p50 / p99 / QPS / SLO attainment / recall@10 come from the rest.

The built states are handed to every Frontend and never written: a
refresh swaps a new state into the Engine, the ChurnController's staging
install makes a new state, and churn's ops copy before they write.

    PYTHONPATH=src python -m repro_torch.bench.serve_load [--fast] \\
        [--device cpu] [--out DIR]

prints JSON lines (results, checks, device) and exits 1 when a check
fails; ``--out`` (or ``$REPRO_BENCH_DIR``) appends the run to
``BENCH_torch_serve.json`` through ``obs.write_bench``.
``adaptive_beats_best_fixed_p99_at_equal_recall`` is a timing claim.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch import rotations, search, serve
from repro_torch import device as _device
from repro_torch.bench import common
from repro_torch.core import givens
from repro_torch.data import synthetic
from repro_torch.metrics import recall_at_k
from repro_torch.obs import jsonable

NAMESPACES = ("alpha", "beta")
POOL = 64
#: calibration frontends whose median top-rung time sets the arrival rate
CALIBRATIONS = 3
FAST = dict(n=8000, dim=32, lists=128, subspaces=16, codewords=64,
            ladder=(2, 4, 16), requests=600, max_admit=8, refresh_every=150)


def emit(name: str, **fields) -> None:
    common.emit("serve_load", name, **jsonable(fields))


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _cross_subspace_delta(R, dim, step):
    """A full-width GCD delta from a seeded Gaussian G: not within a
    subspace, so a fused backend must invalidate its cached LUTs."""
    g = torch.Generator(device=R.device)
    g.manual_seed(7000 + step)
    G = torch.randn((dim, dim), generator=g, device=R.device)
    learner = rotations.make("gcd")
    _, delta = learner.update(learner.init_from(R), G, 1e-3)
    return delta


def namespace_corpus(state, X: torch.Tensor, pool: torch.Tensor) -> dict:
    """One namespace's served state, its query pool as host rows and the
    pool's exact top-10 over ``X`` (MIPS is rotation-invariant, so the
    truth comes from the raw vectors)."""
    truth = torch.topk(pool @ X.T, 10, dim=1).indices
    return dict(state=state, pool=pool.cpu().numpy(),
                truth=truth.cpu().numpy())


def _build_states(*, n, dim, lists, subspaces, codewords, nprobe, seed=0,
                  device=None):
    """One fused-refresh IVF state a namespace, with its pool and truth."""
    dev = _device.resolve(device)
    s = search.make("ivf")
    cfg = search.SearchConfig(
        num_lists=lists, subspaces=subspaces, codewords=codewords,
        nprobe=nprobe, train_size=min(n, 16384), fused_refresh=True)
    out = {}
    for i, name in enumerate(NAMESPACES):
        base = seed + 10 * i
        X = synthetic.sift_like(_device.generator(base, dev), n, dim,
                                device=dev)
        R = givens.random_rotation(_device.generator(base + 1, dev), dim,
                                   device=dev)
        state = s.build(_device.generator(base + 2, dev), X, R, cfg,
                        device=dev)
        pool = synthetic.sift_like(_device.generator(base + 3, dev), POOL,
                                   dim, device=dev)
        out[name] = namespace_corpus(state, X, pool)
    return s, out


def _make_frontend(searcher, corpora, *, ladder, fixed_nprobe, slo_ms,
                   admission_ms, max_admit, clock):
    """One cell's Frontend: adaptive (``ladder``) or fixed
    (``fixed_nprobe`` as each Engine's default, no adaptation)."""
    fe = serve.Frontend(slo_ms=slo_ms, clock=clock.now, advance=clock.advance,
                        lut_budget_rows=4096)
    for name in NAMESPACES:
        c = corpora[name]
        ekw = {"min_bucket": max_admit}
        if fixed_nprobe is not None:
            ekw["nprobe"] = fixed_nprobe
        churn = {"staging_rows": 256} if name == "alpha" else None
        fe.create_namespace(
            name, searcher, c["state"], k=10,
            nprobe_ladder=ladder if fixed_nprobe is None else None,
            admission_ms=admission_ms, max_admit=max_admit, churn=churn,
            warmup_queries=c["pool"][:4], engine_kwargs=ekw)
    return fe


def _arrival_trace(rng, *, requests, rate_qps, pool_size):
    """(t, namespace, pool index) triples: one seeded trace replayed by
    every cell, the JAX script's numpy draws."""
    gaps = rng.exponential(1.0 / rate_qps, size=requests)
    ts = np.cumsum(gaps)
    names = rng.integers(0, len(NAMESPACES), size=requests)
    qis = rng.integers(0, pool_size, size=requests)
    return [(float(ts[i]), NAMESPACES[int(names[i])], int(qis[i]))
            for i in range(requests)]


def _pool_index(ticket, corpora):
    """Which pool row a ticket served, from its host query bytes (rows of a
    64-query pool are distinct)."""
    pool = corpora[ticket.namespace]["pool"]
    hit = np.flatnonzero((pool == ticket.query).all(axis=1))
    return int(hit[0])


def _run_cell(searcher, corpora, trace, *, ladder, fixed_nprobe, slo_ms,
              admission_ms, max_admit, dim, refresh_every, warm_frac):
    """Replay one trace through one Frontend configuration; the cell's
    measured-phase metrics."""
    clock = serve.VirtualClock()
    fe = _make_frontend(searcher, corpora, ladder=ladder,
                        fixed_nprobe=fixed_nprobe, slo_ms=slo_ms,
                        admission_ms=admission_ms, max_admit=max_admit,
                        clock=clock)
    spaces = {name: fe.namespaces.get(name) for name in NAMESPACES}
    warm_at = int(len(trace) * warm_frac)
    measured_from = {name: None for name in NAMESPACES}  # compiles at cutoff

    done, i, refreshes = [], 0, 0
    while i < len(trace) or fe.next_deadline() is not None:
        nd = fe.next_deadline()
        na = trace[i][0] if i < len(trace) else None
        if nd is None and na is None:
            break
        clock.set(min(t for t in (nd, na) if t is not None))
        while i < len(trace) and trace[i][0] <= clock.now():
            t_arr, name, qi = trace[i]
            fe.submit(name, corpora[name]["pool"][qi], arrival=t_arr)
            i += 1
            if i == warm_at:
                for nm, ns in spaces.items():
                    measured_from[nm] = ns.engine.stats()["compiles"]
            if refresh_every and i % refresh_every == 0:
                # alpha absorbs a rotation step between batches
                eng = spaces["alpha"].engine
                eng.refresh(_cross_subspace_delta(
                    eng.state.index.R, dim, step=i))
                refreshes += 1
        done.extend(fe.poll())
    done.extend(fe.drain())
    if len(done) != len(trace):
        raise RuntimeError(f"served {len(done)} of {len(trace)} requests")

    done.sort(key=lambda t: t.arrival)
    meas = done[warm_at:]
    lats = [t.latency_ms for t in meas]
    rung_mix = {}
    for t in meas:
        rung_mix[t.nprobe_served] = rung_mix.get(t.nprobe_served, 0) + 1
    # one copy of the served ids to the host, after the cell
    ids = torch.stack([t.result.ids for t in meas]).cpu().numpy()
    recs = [recall_at_k(
        ids[j][None, :],
        corpora[t.namespace]["truth"][_pool_index(t, corpora)][None, :])
        for j, t in enumerate(meas)]
    span_s = max(t.completed for t in meas) - min(t.arrival for t in meas)
    stats = fe.stats()
    steady_recompiles = sum(
        stats["namespaces"][nm]["compiles"] - measured_from[nm]
        for nm in NAMESPACES if measured_from[nm] is not None)
    return dict(
        requests=len(meas),
        qps=len(meas) / span_s if span_s > 0 else 0.0,
        p50_ms=_percentile(lats, 50), p99_ms=_percentile(lats, 99),
        slo_attainment=float(np.mean([t.latency_ms <= t.slo_ms
                                      for t in meas])),
        recall=float(np.mean(recs)),
        rung_mix={str(r): c for r, c in sorted(rung_mix.items())},
        sheds=stats["sheds"], flushes=stats["flushes"],
        maintenance_ticks=stats["maintenance_ticks"],
        steady_recompiles=steady_recompiles,
        alpha_refreshes=refreshes,
        alpha_lut_invalidations=(
            stats["namespaces"]["alpha"]["lut_invalidations"]),
        beta_lut_invalidations=(
            stats["namespaces"]["beta"]["lut_invalidations"]),
        beta_lut_epoch=stats["namespaces"]["beta"]["lut_epoch"],
        lut_evictions={nm: stats["namespaces"][nm]["lut_evictions"]
                       for nm in NAMESPACES},
        ewma_ms={nm: stats["namespaces"][nm]["slo"]["cells"]
                 for nm in NAMESPACES},
    )


def serve_cells(searcher, corpora, *, dim, ladder=(2, 8, 32),
                requests=1500, load=1.1, slo_factor=4.0, admission_ms=2.0,
                max_admit=16, refresh_every=200, warm_frac=0.3,
                verbose=True):
    """Calibrate the rate, replay one trace through every cell; returns
    (results, checks). ``corpora`` maps each namespace to
    ``namespace_corpus``'s dict."""
    out = (lambda **f: emit("cell", **f)) if verbose else (lambda **f: None)
    ladder = tuple(sorted(ladder))

    # the arrival rate from throwaway adaptive frontends' warm-up models:
    # load × the top rung's full-bucket throughput, the median over
    # CALIBRATIONS frontends (the JAX script times one)
    top_samples = []
    for _ in range(CALIBRATIONS):
        cal = _make_frontend(searcher, corpora, ladder=ladder,
                             fixed_nprobe=None, slo_ms=1e9,
                             admission_ms=admission_ms, max_admit=max_admit,
                             clock=serve.VirtualClock())
        top_samples.append(max(
            cal.namespaces.get(nm).slo.predict_ms(max_admit, ladder[-1])
            for nm in NAMESPACES))
        del cal
    top_ms = statistics.median(top_samples)
    rate_qps = load * max_admit / (top_ms * 1e-3)
    slo_ms = slo_factor * top_ms

    trace = _arrival_trace(np.random.default_rng(42), requests=requests,
                           rate_qps=rate_qps,
                           pool_size=corpora["alpha"]["pool"].shape[0])
    kw = dict(slo_ms=slo_ms, admission_ms=admission_ms,
              max_admit=max_admit, dim=dim, refresh_every=refresh_every,
              warm_frac=warm_frac)
    cells = {}
    for rung in ladder:
        cells[f"fixed_np{rung}"] = _run_cell(
            searcher, corpora, trace, ladder=ladder, fixed_nprobe=rung, **kw)
        out(cell=f"fixed_np{rung}", **cells[f"fixed_np{rung}"])
    cells["adaptive"] = a = _run_cell(
        searcher, corpora, trace, ladder=ladder, fixed_nprobe=None, **kw)
    out(cell="adaptive", **a)

    # comparable fixed baselines: equal or better recall (within 0.01)
    comparable = {name: c for name, c in cells.items()
                  if name != "adaptive" and c["recall"] >= a["recall"] - 0.01}
    best_fixed_p99 = (min(c["p99_ms"] for c in comparable.values())
                      if comparable else float("inf"))

    results = dict(
        rate_qps=rate_qps, slo_ms=slo_ms, top_ms=top_ms,
        top_ms_samples=top_samples,
        ladder=list(ladder), requests=requests, cells=cells,
        comparable_fixed=sorted(comparable),
        best_fixed_p99_ms=best_fixed_p99,
    )
    checks = dict(
        adaptive_beats_best_fixed_p99_at_equal_recall=(
            bool(comparable) and a["p99_ms"] < best_fixed_p99),
        zero_steady_state_recompiles=all(
            c["steady_recompiles"] == 0 for c in cells.values()),
        zero_cross_namespace_lut_invalidations=all(
            c["beta_lut_invalidations"] == 0 and c["beta_lut_epoch"] == 0
            for c in cells.values()),
        refresh_isolation_exercised=(
            a["alpha_refreshes"] >= 1 and a["alpha_lut_invalidations"] >= 1),
        adaptive_sheds_under_load=a["sheds"] >= 1,
        maintenance_ticks_in_idle_slots=a["maintenance_ticks"] >= 1,
    )
    return results, checks


def run(*, n=50_000, dim=64, lists=256, subspaces=32, codewords=64,
        ladder=(2, 8, 32), requests=1500, load=1.1, slo_factor=4.0,
        admission_ms=2.0, max_admit=16, refresh_every=200, warm_frac=0.3,
        verbose=True, device=None):
    """Build both namespaces on ``device`` (the card unless the caller
    passes ``device="cpu"``) and run every cell on one trace; returns
    (results, checks)."""
    dev = _device.resolve(device)
    ladder = tuple(sorted(ladder))
    searcher, corpora = _build_states(
        n=n, dim=dim, lists=lists, subspaces=subspaces,
        codewords=codewords, nprobe=ladder[-1], device=dev)
    results, checks = serve_cells(
        searcher, corpora, dim=dim, ladder=ladder, requests=requests,
        load=load, slo_factor=slo_factor, admission_ms=admission_ms,
        max_admit=max_admit, refresh_every=refresh_every,
        warm_frac=warm_frac, verbose=verbose)
    results.update(n=n, dim=dim, lists=lists, subspaces=subspaces,
                   codewords=codewords)
    if verbose:
        emit("results", **{k: v for k, v in results.items()
                           if k != "cells"})
        emit("checks", passed=all(checks.values()), **checks)
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--lists", type=int, default=64)
    ap.add_argument("--requests", type=int, default=1500)
    ap.add_argument("--load", type=float, default=1.1,
                    help="arrival rate as a fraction of top-rung capacity "
                         "(>1 = the top rung alone cannot keep up)")
    ap.add_argument("--slo-factor", type=float, default=4.0,
                    help="per-request SLO as a multiple of the top rung's "
                         "full-bucket service time")
    ap.add_argument("--fast", action="store_true",
                    help="the JAX script's --fast sizes")
    ap.add_argument("--out", default=None,
                    help="BENCH_torch_serve.json destination dir (default "
                         "$REPRO_BENCH_DIR; unset: print only)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(n=args.n, dim=args.dim, lists=args.lists,
              requests=args.requests, load=args.load,
              slo_factor=args.slo_factor)
    if args.fast:
        kw = dict(FAST, load=args.load, slo_factor=args.slo_factor)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res, checks = run(device=dev, **kw)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))

    out_dir = args.out or os.environ.get("REPRO_BENCH_DIR")
    if out_dir:
        from repro_torch import obs
        path = obs.write_bench(out_dir, "torch_serve",
                               sections={"serve": res}, checks=checks,
                               config=vars(args))
        errs = obs.validate_bench(path)
        emit("bench", path=path, valid=not errs, errors=errs)
        if errs:
            return 1
    if not all(checks.values()):
        print("# FAILED checks:",
              sorted(k for k, v in checks.items() if not v), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
