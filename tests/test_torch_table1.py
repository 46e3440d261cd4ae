"""The port's Fig 3 / Table 1 protocol (``repro_torch.bench.fig3_table1_e2e``)
on the CPU at the size ``tests/test_system.py`` runs the JAX script at:
40 joint steps after 20 warm-up steps, batch 32, 512 items.

Asserted, as the JAX package's test asserts for its script: every
trainable GCD row ends below the frozen control's distortion; and the two
checks that hold by construction, Cayley's R leaves the warm start and the
frozen R does not. The two ordering checks (GCD-G within 5% of GCD-R,
GCD-S within 5% of GCD-G) are reported in the failure message, not
asserted: at this size the JAX rows differ by 1.7e-5 relative, below what
the protocol resolves.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from repro_torch.bench import fig3_table1_e2e as bench


@pytest.fixture(scope="module")
def table1():
    return bench.run(steps=40, warmup=20, batch=32, item_vocab=512,
                     verbose=False, device="cpu")


def test_rows_are_the_papers_table1(table1):
    results, checks = table1
    assert list(results) == ["cayley_sgd", "frozen", "gcd_random",
                             "gcd_greedy", "gcd_steepest"]
    for row in results.values():
        assert 0 < row["distortion"] < 1
        assert 0 <= row["p@50"] <= 1 and row["p@50"] == row["r@50"]
    assert set(checks) == {"trainable_beats_frozen", "greedy_le_random",
                           "steepest_le_greedy", "cayley_r_trains",
                           "frozen_r_stays"}


@pytest.mark.parametrize("check", ["trainable_beats_frozen",
                                   "cayley_r_trains", "frozen_r_stays"])
def test_table1_check_holds(table1, check):
    results, checks = table1
    assert checks[check], json.dumps({"checks": checks, "rows": results},
                                     indent=1)


def test_gcd_rows_move_r_and_frozen_keeps_it(table1):
    results, _ = table1
    assert results["frozen"]["dR_from_warmstart"] == 0.0
    for m in ("gcd_random", "gcd_greedy", "gcd_steepest"):
        assert results[m]["dR_from_warmstart"] > 0.0, m


def test_run_is_deterministic_and_restores_the_mode(monkeypatch):
    """``run()`` computes under deterministic algorithms (one answer per
    seed, as XLA gives the JAX script) and leaves the caller's mode and
    cuBLAS workspace setting as they were."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    seen = []
    real = bench._run

    def spy(*args):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
        return real(*args)

    monkeypatch.setattr(bench, "_run", spy)
    assert not torch.are_deterministic_algorithms_enabled()
    small = dict(steps=3, warmup=2, batch=8, item_vocab=128, verbose=False,
                 device="cpu")
    first, _ = bench.run(**small)
    second, _ = bench.run(**small)
    assert seen == [(True, ":4096:8")] * 2
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    for m in first:
        assert first[m]["distortion"] == second[m]["distortion"], m
        assert (first[m]["dR_from_warmstart"]
                == second[m]["dR_from_warmstart"]), m
