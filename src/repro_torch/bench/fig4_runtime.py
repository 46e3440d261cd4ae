"""Fig 4 of the paper on the port (port of ``benchmarks/fig4_runtime.py``,
App. B): the runtime of one rotation update against the dimension.

Every learner of the registry but the frozen control is timed through the
same protocol call, ``learner.update(state, G, lr, generator)``, at batch
1 (G is the gradient of sum((X·R)·w) at R = I for one row X), for
n ∈ {64, 128, 256, 512}; ``subspace_gcd`` at sub = n // 8, and
Procrustes' update is its projected-SGD step (a full SVD a step). Also
timed: the serial and the round-wise greedy matching (``greedy_matching``,
``greedy_matching_fast``) on G − Gᵀ, and the closed-form Procrustes solve
on (256, n) operands, the OPQ inner step GCD replaces. The paper's claims
are trends: GCD-R well below Cayley at the largest n, and growing more
slowly than it; the two checks are the JAX script's expressions.

Each figure is the median wall time of 5 calls after 2 warm-ups, with the
device synchronised on both sides of every call, in µs
(``common.time_call``), as ``benchmarks/common.py`` times the JAX
functions. The JAX script times jit-compiled functions; here each call is
the eager update the trainer runs. GCD-G's matching runs on the host, so
the wall time is the paper's quantity; ``run`` can also hand back each
call's median CUDA-event time, each learner's orthogonality error after
its timed calls and how far that moved R.

    PYTHONPATH=src python -m repro_torch.bench.fig4_runtime [--device cpu]

prints one JSON line per learner and n, one per check, the GCD-R split at
n = 512 (``gcd_random_split``) and the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch import rotations
from repro_torch.bench import common
from repro_torch.core import givens, matching
from repro_torch.kernels import ops as kops
from repro_torch.rotations.procrustes import procrustes_rotation

# registry learners timed per update step (subspace_gcd at sub = n // 8;
# procrustes' update is the projected-SGD step, its closed-form solve is
# timed apart)
SWEEP = [n for n in rotations.names() if n != "frozen"]
DIMS = (64, 128, 256, 512)
LR = 1e-3
SOLVE_ROWS = 256


def emit(name: str, **fields) -> None:
    common.emit("fig4", name, **fields)


def _operands(n: int, seed: int, dev: torch.device):
    """(G, generator): G = ∇_R Σ (X·R)·w at R = I = Xᵀw for one row X and
    a weight vector w, both drawn from a generator made from ``seed``."""
    g = _device.generator(seed, dev)
    X = torch.randn((1, n), generator=g, device=dev)
    w = torch.randn((n,), generator=g, device=dev)
    return torch.outer(X[0], w), g


def run(dims=DIMS, verbose=True, *, seed=0, device=None, detail=None):
    """(out, checks) as the JAX script returns them: ``out[n][name]`` the
    median wall µs of each learner's update and of the three extra
    calls, and the two checks. ``detail``, a dict if given, receives
    ``device_us[n][name]`` (CUDA-event µs, None on the CPU), and
    ``orth_err[n][spec]`` and ``move[n][spec]``: max |RᵀR − I| and
    max |R − I| of the state each learner's last timed call returned."""
    dev = _device.resolve(device)
    out, dev_us, orth, move = {}, {}, {}, {}
    for n in dims:
        G, g = _operands(n, seed, dev)
        eye = torch.eye(n, device=dev)
        res, dres, oerr, mv = {}, {}, {}, {}
        for spec in SWEEP:
            kw = {"sub": n // 8} if spec == "subspace_gcd" else {}
            learner = rotations.make(spec, **kw)
            state = learner.init(n, device=dev)
            gen = _device.generator(seed, dev)
            res[spec], dres[spec], last = common.time_call(
                lambda lrn=learner, st=state, k=gen: lrn.update(
                    st, G, LR, k)[0], dev)
            R = learner.materialize(last)
            oerr[spec] = float(givens.orthogonality_error(R))
            mv[spec] = float((R - eye).abs().max())
        A = G - G.T
        res["match_greedy_serial"], dres["match_greedy_serial"], _ = \
            common.time_call(lambda: matching.greedy_matching(A), dev)
        res["match_greedy_fast"], dres["match_greedy_fast"], _ = \
            common.time_call(lambda: matching.greedy_matching_fast(A), dev)
        Y = torch.randn((SOLVE_ROWS, n), generator=g, device=dev)
        Z = torch.randn((SOLVE_ROWS, n), generator=g, device=dev)
        res["procrustes_solve"], dres["procrustes_solve"], _ = \
            common.time_call(lambda: procrustes_rotation(Y, Z), dev)
        out[n], dev_us[n], orth[n], move[n] = res, dres, oerr, mv
        if verbose:
            for k, v in res.items():
                emit(f"fig4/n{n}/{k}", wall_us=v, device_us=dres[k],
                     orth_err=oerr.get(k))
    top, base = max(dims), min(dims)
    checks = {
        f"gcd_r_faster_than_cayley_at_{top}": out[top]["gcd_random"]
        < out[top]["cayley_sgd"],
        "gcd_scales_better": (out[top]["gcd_random"]
                              / out[base]["gcd_random"])
        < (out[top]["cayley_sgd"]
           / max(out[base]["cayley_sgd"], 1e-9)) * 2.0,
    }
    if verbose:
        for k, v in checks.items():
            emit(f"fig4/check/{k}", passed=v)
    if detail is not None:
        detail.update(device_us=dev_us, orth_err=orth, move=move)
    return out, checks


def gcd_random_split(n: int = 512, reps: int = 20, *, seed=0,
                     device=None) -> dict:
    """GCD-R's update at n, part by part, each part timed alone with the
    device synchronised around it (median wall µs and CUDA-event µs over
    ``reps`` after 2 warm-ups): ``score`` (A = GᵀR − RᵀG, the gcd_score
    kernel), ``pairs`` (the random matching, a ``randperm``), ``angles``
    (θ = −lr·A[pi, pj]/√2), ``check`` (``kops._disjoint_pairs``: the pairs'
    disjointness test and its host synchronisation), ``apply`` (the
    givens_rotate kernel on R), and ``update``, the whole call."""
    dev = _device.resolve(device)
    G, _ = _operands(n, seed, dev)
    learner = rotations.make("gcd_random")
    state = learner.init(n, device=dev)
    R = state.R
    gen = _device.generator(seed, dev)
    A = kops.gcd_score(G, R)
    pi, pj = matching.random_matching(gen, n, device=dev)
    theta = -LR * A[pi, pj] / givens.SQRT2
    pi32, pj32 = kops._disjoint_pairs(pi, pj, n)
    parts = {
        "score": lambda: kops.gcd_score(G, R),
        "pairs": lambda: matching.random_matching(gen, n, device=dev),
        "angles": lambda: -LR * A[pi, pj] / givens.SQRT2,
        "check": lambda: kops._disjoint_pairs(pi, pj, n),
        "apply": lambda: kops._PairRotation.apply(R, theta, pi32, pj32),
        "update": lambda: learner.update(state, G, LR, gen),
    }
    out = {}
    for name, fn in parts.items():
        wall, dv, _ = common.time_call(fn, dev, iters=reps)
        out[name] = dict(wall_us=wall, device_us=dv)
    return out


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
    emit("fig4/gcd_random_split/n512", **gcd_random_split(device=dev))
    emit("device", type=dev.type, seconds=time.perf_counter() - t0,
         device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
