"""The port's Fig 2a, Fig 2b/c and Fig 4 scripts
(``repro_torch.bench.fig2a_convergence``, ``fig2bc_stability``,
``fig4_runtime``) on the CPU at tiny sizes: each ``run()`` returns the
structure the JAX script's ``run()`` returns (every key of it, the same
check names), sweeps the JAX script's solver list, and computes its checks
by the JAX script's expressions. The figures' claims are trends at the
scripts' default sizes on the card (``chip_smoke.py``'s fig4 and fig2
phases); here they are not asserted."""
from __future__ import annotations

import numpy as np
import pytest

from benchmarks import fig2a_convergence as jfig2a
from benchmarks import fig4_runtime as jfig4
from repro_torch.bench import fig2a_convergence as fig2a
from repro_torch.bench import fig2bc_stability as fig2bc
from repro_torch.bench import fig4_runtime as fig4


@pytest.fixture(scope="module")
def fig4_small():
    detail = {}
    out, checks = fig4.run(dims=(8, 16), verbose=False, device="cpu",
                           detail=detail)
    return out, checks, detail


def test_fig4_returns_the_jax_structure(fig4_small):
    out, checks, detail = fig4_small
    assert fig4.SWEEP == jfig4.SWEEP
    assert set(out) == {8, 16}
    want = set(jfig4.SWEEP) | {"match_greedy_serial", "match_greedy_fast",
                               "procrustes_solve"}
    for n in out:
        assert set(out[n]) == want
        assert all(np.isfinite(v) and v > 0 for v in out[n].values())
        assert set(detail["device_us"][n]) == want
        assert all(v is None for v in detail["device_us"][n].values())
    assert set(checks) == {"gcd_r_faster_than_cayley_at_16",
                           "gcd_scales_better"}
    top, base = out[16], out[8]
    assert checks["gcd_r_faster_than_cayley_at_16"] == (
        top["gcd_random"] < top["cayley_sgd"])
    assert checks["gcd_scales_better"] == (
        top["gcd_random"] / base["gcd_random"]
        < top["cayley_sgd"] / base["cayley_sgd"] * 2.0)


def test_fig4_learners_keep_r_orthogonal(fig4_small):
    _, _, detail = fig4_small
    for n, errs in detail["orth_err"].items():
        assert set(errs) == set(fig4.SWEEP)
        for spec, err in errs.items():
            assert err < 1e-5, (n, spec)
            # subspace_gcd at n = 8 has subspaces of one axis: no plane
            # inside one, so every angle is 0
            moved = detail["move"][n][spec] > 0
            assert moved == (spec != "subspace_gcd" or n // 8 > 1), (n, spec)


def test_gcd_random_split_times_every_part():
    parts = fig4.gcd_random_split(16, reps=2, device="cpu")
    assert set(parts) == {"score", "pairs", "angles", "check", "apply",
                          "update"}
    assert all(p["wall_us"] > 0 and p["device_us"] is None
               for p in parts.values())


def test_fig2a_returns_the_jax_structure():
    results, checks = fig2a.run(num=256, dim=16, D=4, K=8, iters=3,
                                inner=2, verbose=False, device="cpu")
    assert fig2a.SOLVERS == jfig2a.SOLVERS and fig2a.LRS == jfig2a.LRS
    assert list(results) == jfig2a.SOLVERS
    for solver, r in results.items():
        assert {"trace", "final", "us_per_iter"} <= set(r)
        assert r["trace"].shape == (3,) and np.all(np.isfinite(r["trace"]))
        assert r["final"] == float(r["trace"][-1])
        assert r["orth_err"] < 1e-5, solver
    assert results["frozen"]["dR_from_identity"] == 0.0
    assert set(checks) == {"gcd_g_close_to_opq", "gcd_s_close_to_opq",
                           "gcd_g_beats_overlap_g", "gcd_g_beats_random",
                           "gcd_g_beats_cayley", "all_beat_frozen"}
    margins = fig2a.margins_of(results)
    assert set(margins) == set(checks)
    for k in ("gcd_g_close_to_opq", "gcd_s_close_to_opq", "all_beat_frozen"):
        assert checks[k] == (margins[k] > 0) or abs(margins[k]) < 1e-6, k


def test_fig2bc_returns_the_jax_structure():
    out, stable = fig2bc.run(num=200, dim=16, D=4, K=8, iters=2, runs=2,
                             verbose=False, device="cpu")
    assert set(out) == {0.1, 0.5, 1.0}
    for frac, stats in out.items():
        assert set(stats) == {"procrustes", "gcd_greedy"}
        for s in stats.values():
            assert {"mean", "std"} <= set(s)
            assert s["finite"] and s["orth_err"] < 1e-5
            assert np.isfinite(s["mean"]) and s["std"] >= 0
    assert stable == all(out[f]["gcd_greedy"]["std"]
                         <= out[f]["procrustes"]["std"] * 1.5 for f in out)
    assert (fig2bc.margin_of(out) >= 0) == stable
