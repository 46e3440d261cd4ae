"""The port's three examples (``repro_torch.examples``: quickstart,
serve_ann, train_twotower) at small sizes on the CPU, held by property on
the dicts their ``main``/``run`` return. Their data come from
``torch.Generator``s, which JAX threefry cannot reproduce (ROADMAP.md,
parity hazards, "PRNG"); the modules they drive are held against the JAX
package by the other ``test_torch_*`` files."""
from __future__ import annotations

import pytest
import torch

from repro_torch import search
from repro_torch.examples import quickstart, serve_ann, train_twotower


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one machine."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def test_quickstart_learners_and_every_backend():
    """Every learner keeps R orthogonal (1e-4), GCD-G ends below frozen's
    distortion, every registered backend is served, ``exact`` and its
    streaming twin find the truth, and the sharded twins (one CPU shard)
    return their replicated twins' recall."""
    out = quickstart.main(["--device", "cpu"], num=1024, iters=6,
                          queries=32)
    learners = out["learners"]
    assert set(learners) == {s for s, _ in quickstart.SOLVERS}
    for name, r in learners.items():
        assert r["orthogonality_error"] <= 1e-4, name
    assert learners["frozen"]["orthogonality_error"] == 0.0
    assert (learners["gcd_greedy"]["distortion_last"]
            < learners["frozen"]["distortion_last"])
    assert tuple(out["backends"]) == search.names()
    assert out["backends"]["exact"]["recall"] == 1.0
    assert out["backends"]["exact_stream"]["recall"] == 1.0
    for name, r in out["backends"].items():
        assert 0.0 < r["recall"] <= 1.0 and r["scanned"] > 0, name
    assert out["backends"]["ivf"]["scanned"] < 1024
    for twin in ("exact", "flat_adc", "ivf"):
        name = ("flat" if twin == "flat_adc" else twin) + "_sharded"
        assert out["backends"][name]["shards"] == 1
        assert out["backends"][name]["recall"] == out["backends"][twin][
            "recall"], name


def test_serve_ann_refresh_keeps_executables():
    """The Engine serves the four ragged spans at nprobe 8 and 32 (the
    wider probe recalls no less); the subspace-GCD refresh adds no
    executable, keeps R orthogonal, and leaves at most 1% of the codes
    different from a re-encode (``tests/test_ivf.py:112``)."""
    out = serve_ann.main(["--device", "cpu"], N=6000, K=64, L=32,
                         learn_rows=2048, opq_iters=3, train_size=4096,
                         queries=256)
    e8, e32 = out["engines"][8], out["engines"][32]
    for e in (e8, e32):
        assert e["requests"] == len(serve_ann.SPANS)
        assert e["queries"] == 512
        assert e["compiles"] == e["executables"] == 3
        assert e["lut_hit_rate"] == 0.5         # the last span repeats
    assert e32["recall"] >= e8["recall"] > 0.0
    r = out["refresh"]
    assert r["executables_after"] == r["executables_before"] == 1
    assert r["orthogonality_drift"] <= 1e-5
    assert r["refresh_mismatch"] <= 0.01
    assert 0.0 < r["recall_after"] <= 1.0
    assert out["learn"]["distortion_last"] < out["learn"]["distortion_first"]


def test_train_twotower_resume_is_bit_equal(tmp_path):
    """A run checkpointed every 5 steps and a second run resumed from its
    newest checkpoint (step 15, after the warm start) end at the same
    loss and p@50, bit for bit; a run in another directory starts over
    and ends there too."""
    kw = dict(steps=12, warmup=6, batch=32, items=3000, ckpt_every=5,
              opq_iters=3, sample=512, device="cpu")
    a = train_twotower.run(ckpt_dir=str(tmp_path / "a"), **kw)
    b = train_twotower.run(ckpt_dir=str(tmp_path / "a"), **kw)
    assert a["resumed_from"] is None and b["resumed_from"] == 15
    assert a["steps_run"] == 18 and b["steps_run"] == 3
    assert b["final_loss"] == a["final_loss"]
    assert b["p_at_50"] == a["p_at_50"]
    assert 0.0 <= a["p_at_50"] <= 1.0
    assert a["n_params"] == 3000 * 256 + 2 * (256 * 256 + 256 + 256 * 128
                                              + 128) + 128 * 128 + 16 * 64 * 8
    c = train_twotower.run(ckpt_dir=str(tmp_path / "c"), **kw)
    assert c["final_loss"] == a["final_loss"]


@pytest.mark.parametrize("mod", [quickstart, serve_ann, train_twotower])
def test_examples_default_to_the_card(mod, monkeypatch):
    """Without ``--device`` an example runs on the card, and raises on a
    machine without one instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
