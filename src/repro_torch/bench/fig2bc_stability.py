"""Fig 2b/c of the paper on the port (port of
``benchmarks/fig2bc_stability.py``): convergence stability across runs
and data sizes.

The paper's claim: GCD-G converges with a lower run-to-run variance than
OPQ, and degrades more gracefully on small data fractions. At the JAX
script's sizes (N = 4096, n = 64, D = 8, K = 32, 20 iterations, 5 runs,
lr 2e-3 and 5 inner steps) it sweeps the data fractions 10%, 50% and
100%: run r takes the rows of numpy's ``RandomState(r)`` permutation, as
the JAX script does, and its OPQ loop a generator made from 100 + r. The
check is the JAX script's: at every fraction GCD-G's std of the final
distortion is at most 1.5 × OPQ's. The data come from a torch generator
(other numbers than the JAX script's ``PRNGKey(0)``); ``margin_of`` gives
how far the check is from flipping. ``run()`` runs under deterministic
algorithms, as ``fig2a_convergence.run()`` does.

    PYTHONPATH=src python -m repro_torch.bench.fig2bc_stability \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import quant
from repro_torch.bench import common
from repro_torch.core import givens
from repro_torch.data import synthetic
from repro_torch.quant import opq

FRACTIONS = (0.1, 0.5, 1.0)
SOLVERS = ("procrustes", "gcd_greedy")
STD_SLACK = 1.5                 # GCD-G's std against OPQ's, at most


def emit(name: str, **fields) -> None:
    common.emit("fig2bc", name, **fields)


def margin_of(out: dict) -> float:
    """How far ``gcd_more_stable`` is from flipping: the least, over the
    fractions, of STD_SLACK − GCD-G's std / OPQ's std (negative: failed)."""
    return min(STD_SLACK - s["gcd_greedy"]["std"]
               / max(s["procrustes"]["std"], 1e-30) for s in out.values())


def run(num=4096, dim=64, D=8, K=32, iters=20, runs=5, verbose=True, *,
        device=None):
    """(out, stable) as the JAX script returns them: ``out[fraction]
    [solver]`` holds the ``mean`` and ``std`` of the final distortions over
    the runs, and also ``finite`` (every trace finite) and ``orth_err``
    (the largest max |RᵀR − I| of the runs' final R); ``stable`` is the
    check. ``device`` is the card unless the caller passes
    ``device="cpu"``."""
    with common.deterministic():
        return _run(num, dim, D, K, iters, runs, verbose,
                    _device.resolve(device))


def _run(num, dim, D, K, iters, runs, verbose, dev):
    cfg = quant.PQConfig(D, K)
    X_full = synthetic.sift_like(_device.generator(0, dev), num, dim,
                                 device=dev)
    out = {}
    for frac in FRACTIONS:
        n = int(num * frac)
        finals = {s: [] for s in SOLVERS}
        finite = {s: True for s in SOLVERS}
        orth = {s: 0.0 for s in SOLVERS}
        for r in range(runs):
            rows = np.random.RandomState(r).permutation(num)[:n]
            Xr = X_full[torch.from_numpy(rows).to(dev)]
            for solver in SOLVERS:
                R, _cb, trace = opq.alternating_minimization(
                    _device.generator(100 + r, dev), Xr, cfg, iters=iters,
                    rotation=solver, inner_steps=5, lr=2e-3)
                trace = trace.cpu().numpy()
                finals[solver].append(float(trace[-1]))
                finite[solver] &= bool(np.all(np.isfinite(trace)))
                orth[solver] = max(orth[solver],
                                   float(givens.orthogonality_error(R)))
        stats = {s: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                     "finite": finite[s], "orth_err": orth[s]}
                 for s, v in finals.items()}
        out[frac] = stats
        if verbose:
            for s in stats:
                emit(f"fig2bc/frac{int(frac * 100)}/{s}", **stats[s])
    # the paper's claim: GCD-G's std at most OPQ's (lower variance)
    stable = all(out[f]["gcd_greedy"]["std"]
                 <= out[f]["procrustes"]["std"] * STD_SLACK for f in out)
    if verbose:
        emit("fig2bc/check/gcd_more_stable", passed=stable,
             margin=margin_of(out))
    return out, stable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    run(device=dev)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
