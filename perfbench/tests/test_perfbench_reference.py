"""The plain references against the port at tiny sizes on the CPU, and
the control (the reference in TF32) coming out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.tests import tiny
from perfbench import harness
from perfbench.reference import ivf_pq, precision, twotower

SERVE = [c for c in tiny.CELLS if c.startswith("retrieval.")]
TRAIN = [c for c in tiny.CELLS if c.startswith("paper.")]


@pytest.mark.parametrize("name", SERVE)
def test_served_answers_equal_the_reference(name):
    checks = tiny.run(name)["checks"]
    assert checks["bad_rows"]["value"] == 0
    assert checks["id_miss_share"]["value"] == 0
    assert checks["score_gap_p90"]["value"] <= 1e-6


@pytest.mark.parametrize("name", TRAIN)
def test_training_steps_equal_the_reference(name):
    checks = tiny.run(name)["checks"]
    for c in checks.values():
        assert c["value"] <= 1e-5


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name, seed):
    cell = tiny.cell(name, seed)
    driver = harness.load_module("drivers", cell.workload["driver"])
    numbers = driver.control(cell)
    assert any(v > cell.limit(k) for k, v in numbers.items()), numbers


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10,
                      -3.0 - 2**-12])
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0])
    assert torch.equal(precision.to_tf32(x), want)


def test_kmeans_repeats_for_a_seed():
    g = torch.Generator().manual_seed(3)
    X = torch.randn(500, 8, generator=g)
    a = ivf_pq.kmeans(torch.Generator().manual_seed(5), X, 16, 4)
    b = ivf_pq.kmeans(torch.Generator().manual_seed(5), X, 16, 4)
    assert torch.equal(a, b)


def test_reference_search_is_exhaustive_at_full_probe():
    """nprobe = L is a flat ADC scan: the reference's answers are then the
    top k of every row's score."""
    g = torch.Generator().manual_seed(7)
    X, Q = torch.randn(600, 16, generator=g), torch.randn(5, 16, generator=g)
    R = torch.linalg.qr(torch.randn(16, 16, generator=g))[0]
    C = ivf_pq.kmeans(g, X @ R, 8, 3)
    cb = ivf_pq.fit_pq(g, X @ R - C[ivf_pq.nearest(X @ R, C)], 4, 8, 3)
    ix = ivf_pq.build(X, R, C, cb)
    sc, ids = ivf_pq.search(ix, Q, R, C, cb, nprobe=8, k=5)
    QR = Q @ R
    rec = C[ix.lists] + cb[torch.arange(4), ix.codes].reshape(600, 16)
    full = QR @ rec.T
    want = torch.topk(full, 5, dim=1)
    assert torch.equal(ids, want.indices)
    assert torch.allclose(sc, want.values, rtol=1e-5, atol=1e-5)


def test_greedy_pairs_match_the_port():
    from repro_torch.core import matching

    rng = np.random.RandomState(0)
    M = rng.randn(64, 64).astype(np.float32)
    A = M - M.T
    pi, pj = twotower.greedy_pairs(A)
    qi, qj = matching.greedy_matching_fast(torch.from_numpy(A))
    assert (pi, pj) == (qi.tolist(), qj.tolist())


def test_reference_hinge_blocks_change_nothing(monkeypatch):
    """The reference forms the scores in row blocks: small blocks give the
    loss and gradients of one block."""
    wl, cfg = tiny.shrink(TRAIN[0])
    cell = tiny.cell(TRAIN[0])
    driver = harness.load_module("drivers", wl["driver"])
    pool, weights = driver.setup_inputs(cell)
    whole = driver.reference(cell, weights, pool)
    monkeypatch.setattr(twotower, "ROWS", 24)
    blocks = driver.reference(cell, weights, pool)
    assert np.allclose(whole["losses"], blocks["losses"], rtol=1e-6)
    for key in ("grad_norms", "change_norms"):
        for k, v in whole[key].items():
            assert blocks[key][k] == pytest.approx(v, rel=1e-4, abs=1e-9)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fault_reads_far_above_a_sound_run(name):
    cell = tiny.cell(name)
    driver = harness.load_module("drivers", cell.workload["driver"])
    numbers = driver.control(cell, "half_batch")
    assert any(v > cell.limit(k) for k, v in numbers.items()), numbers
