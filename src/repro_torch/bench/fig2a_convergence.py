"""Fig 2a of the paper on the port (port of
``benchmarks/fig2a_convergence.py``): fixed-embedding distortion
convergence (paper §3.1).

OPQ (SVD/Procrustes) against Cayley-SGD, GCD-R / GCD-G / GCD-S, the
overlapping ablations and the frozen control, on a SIFT-like anisotropic
mixture at the JAX script's sizes: N = 4096, n = 64, D = 8, K = 32, 25
outer iterations of 5 inner steps. The solver list is the registry (all
but ``subspace_gcd``), the learning rates are the JAX script's ``LRS``,
and the six checks are its expressions:

  * GCD-G and GCD-S converge within 10% of OPQ;
  * overlapping GCD-G does not converge as well (disjointness matters);
  * GCD-R trails GCD-G (steeper directions matter);
  * Cayley converges slower than GCD-G;
  * OPQ, GCD-G and GCD-S all end below the frozen control.

The data come from a torch generator made from ``seed`` (the JAX script
draws them from ``PRNGKey(seed)``: other numbers of the same
distribution), so the port's margins differ from the JAX package's;
``margins_of`` gives how far each check is from flipping, and nothing is
re-seeded to make a check hold. ``run()`` runs under deterministic
algorithms (``common.deterministic``): on the card the k-means sums would
otherwise add in no fixed order, and a seed gives one answer.

    PYTHONPATH=src python -m repro_torch.bench.fig2a_convergence \
        [--seed S] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import quant, rotations
from repro_torch.bench import common
from repro_torch.core import givens
from repro_torch.data import synthetic
from repro_torch.quant import opq

# every registered learner except subspace_gcd (it needs a serving index's
# subspace width)
SOLVERS = [n for n in rotations.names() if n != "subspace_gcd"]
# the JAX script's learning rates (``benchmarks/fig2a_convergence.py``)
LRS = {"cayley_sgd": 3e-4, "gcd_random": 3e-2, "gcd_greedy": 3e-2,
       "gcd_steepest": 2e-2, "gcd_overlap_random": 3e-2,
       "gcd_overlap_greedy": 3e-2}


def emit(name: str, **fields) -> None:
    common.emit("fig2a", name, **fields)


def checks_of(r: dict) -> dict:
    """The JAX script's six checks on the final distortions."""
    return {
        "gcd_g_close_to_opq": r["gcd_greedy"]["final"]
        <= 1.10 * r["procrustes"]["final"],
        "gcd_s_close_to_opq": r["gcd_steepest"]["final"]
        <= 1.10 * r["procrustes"]["final"],
        "gcd_g_beats_overlap_g": r["gcd_greedy"]["final"]
        <= r["gcd_overlap_greedy"]["final"] + 1e-6,
        "gcd_g_beats_random": r["gcd_greedy"]["final"]
        <= r["gcd_random"]["final"] + 1e-6,
        "gcd_g_beats_cayley": r["gcd_greedy"]["final"]
        <= r["cayley_sgd"]["final"] + 1e-6,
        "all_beat_frozen": max(r[s]["final"] for s in
                               ("procrustes", "gcd_greedy", "gcd_steepest"))
        < r["frozen"]["final"],
    }


def margins_of(r: dict) -> dict:
    """How far each check is from flipping, as a fraction of the
    distortion it is held against (negative: failed): the slack left of
    the 1.10 bounds, and 1 − GCD-G's (or the worst trained row's) final
    over the other side's."""
    f = {s: v["final"] for s, v in r.items()}
    return {
        "gcd_g_close_to_opq": 1.10 - f["gcd_greedy"] / f["procrustes"],
        "gcd_s_close_to_opq": 1.10 - f["gcd_steepest"] / f["procrustes"],
        "gcd_g_beats_overlap_g":
            1.0 - f["gcd_greedy"] / f["gcd_overlap_greedy"],
        "gcd_g_beats_random": 1.0 - f["gcd_greedy"] / f["gcd_random"],
        "gcd_g_beats_cayley": 1.0 - f["gcd_greedy"] / f["cayley_sgd"],
        "all_beat_frozen": 1.0 - max(
            f[s] for s in ("procrustes", "gcd_greedy", "gcd_steepest"))
        / f["frozen"],
    }


def run(num=4096, dim=64, D=8, K=32, iters=25, inner=5, seed=0,
        verbose=True, *, device=None):
    """(results, checks) as the JAX script returns them:
    ``results[solver]`` holds the distortion ``trace`` (numpy), its
    ``final`` value and ``us_per_iter``, and also the final R's
    ``orth_err`` (max |RᵀR − I|) and ``dR_from_identity`` (max |R − I|).
    ``device`` is the card unless the caller passes ``device="cpu"``."""
    with common.deterministic():
        return _run(num, dim, D, K, iters, inner, seed, verbose,
                    _device.resolve(device))


def _run(num, dim, D, K, iters, inner, seed, verbose, dev):
    X = synthetic.sift_like(_device.generator(seed, dev), num, dim,
                            device=dev)
    cfg = quant.PQConfig(D, K)
    eye = torch.eye(dim, device=dev)
    results = {}
    for solver in SOLVERS:
        common.sync(dev)
        t0 = time.perf_counter()
        R, _cb, trace = opq.alternating_minimization(
            _device.generator(seed + 1, dev), X, cfg, iters=iters,
            rotation=solver, inner_steps=inner, lr=LRS.get(solver, 1e-3))
        trace = trace.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e6 / iters
        results[solver] = {
            "trace": trace, "final": float(trace[-1]), "us_per_iter": dt,
            "orth_err": float(givens.orthogonality_error(R)),
            "dR_from_identity": float((R - eye).abs().max())}
        if verbose:
            emit(f"fig2a/{solver}", us_per_iter=dt,
                 final_distortion=float(trace[-1]),
                 orth_err=results[solver]["orth_err"])
    checks = checks_of(results)
    if verbose:
        margins = margins_of(results)
        for k, v in checks.items():
            emit(f"fig2a/check/{k}", passed=v, margin=margins[k])
    return results, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    run(seed=args.seed, device=dev)
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
