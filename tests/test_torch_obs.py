"""The port's observability (``repro_torch.obs``, ``index.maintain
.refresh_health``, the Engine's stats) against the JAX package's
``repro.obs`` on the CPU.

The same observations go to a JAX ``Registry`` and to the port's, and
their snapshots, percentiles and text reports must be equal; spans, the
disabled registry and the JSONL log are checked for their own semantics.
The recall probe and the Engine's request stats run over a small index the
JAX package built and ``convert`` carried across.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import rotations as jrot
from repro import search as jsearch
from repro.data import synthetic as jsynth
from repro.index import maintain as jmaintain
from repro_torch import convert, obs, rotations, search
from repro_torch.index import maintain
from repro_torch.obs import registry as reg_mod

DIM, SUB = 16, 4
CFG = dict(num_lists=8, subspaces=SUB, codewords=64, block_size=8, nprobe=4)


def _feed(reg) -> None:
    """One sequence of observations, for a JAX and a port registry."""
    reg.counter("hits").inc()
    reg.counter("hits").inc(4)
    reg.counter("hits", shard=0).inc()
    reg.gauge("recall", k=10).set(0.9)
    reg.gauge("recall", k=10).set(0.7)
    d = reg.distribution("lat")
    for v in np.random.RandomState(0).gamma(2.0, 3.0, size=300):
        d.observe(float(v))


@pytest.mark.parametrize("window", [1, 64, 1024])
def test_registry_snapshot_matches_jax(window):
    """Counters, labels, gauges and window percentiles, metric by metric."""
    jreg, treg = jobs.Registry(window=window), obs.Registry(window=window)
    _feed(jreg)
    _feed(treg)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    assert tsnap["counters"] == jsnap["counters"] == {"hits": 5,
                                                      "hits{shard=0}": 1}
    assert tsnap["gauges"] == jsnap["gauges"]
    assert treg.gauge("recall", k=10).updates == 2
    tl, jl = tsnap["distributions"]["lat"], jsnap["distributions"]["lat"]
    assert tl.keys() == jl.keys()
    for key in tl:
        assert tl[key] == pytest.approx(jl[key], rel=1e-12), key
    for q in (0, 1, 37.5, 50, 99, 100):
        assert treg.distribution("lat").percentile(q) == pytest.approx(
            jreg.distribution("lat").percentile(q), rel=1e-12)
    assert obs.text_report(treg) == jobs.text_report(jreg)


def test_distribution_window_vs_lifetime():
    reg = obs.Registry(window=100)
    d = reg.distribution("lat")
    for v in range(1, 1001):
        d.observe(float(v))
    assert d.count == 1000 and d.min == 1.0 and d.max == 1000.0
    assert d.window_values() == [float(v) for v in range(901, 1001)]
    assert d.percentile(50) == pytest.approx(950.5)
    assert d.summary()["p99"] == pytest.approx(999.01)
    empty = reg.distribution("never")
    assert empty.percentile(99) == 0.0 and empty.summary()["mean"] == 0.0


def test_span_nesting_paths_and_sync():
    reg = obs.Registry()
    with reg.span("serve"):
        with reg.span("engine.search") as sp:
            assert sp.sync(torch.ones(4)) is not None   # a CPU tensor: no-op
    snap = reg.snapshot()
    assert "span.serve.ms" in snap["distributions"]
    assert "span.serve.engine.search.ms" in snap["distributions"]
    names = [e["name"] for e in reg.events("span")]
    assert names == ["serve.engine.search", "serve"]     # inner exits first
    with reg.span("engine.search"):
        pass
    assert reg.events("span")[-1]["name"] == "engine.search"


def test_span_sync_finds_cuda_tensors_in_containers(monkeypatch):
    """``sync`` waits on the device of every CUDA tensor it is given,
    wherever it sits in the state; CPU tensors need no wait."""
    seen = []
    monkeypatch.setattr(reg_mod.torch.cuda, "synchronize", seen.append)
    cuda = torch.empty(0, device="meta")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(
        lambda t: t.device.type == "meta"))
    state = search.ADCState(index=None, max_blocks=1, rot=cuda)
    reg_mod.synchronize([state, {"a": (torch.ones(1), cuda)}])
    assert seen == [cuda.device]
    reg_mod.synchronize(torch.ones(2))
    assert seen == [cuda.device]


def test_span_exception_safety():
    reg = obs.Registry()
    with pytest.raises(ValueError, match="boom"):
        with reg.span("outer"):
            with reg.span("inner"):
                raise ValueError("boom")
    evs = {e["name"]: e for e in reg.events("span")}
    assert evs["outer.inner"]["error"] is True
    assert evs["outer"]["error"] is True
    assert reg._span_stack() == []
    with reg.span("after"):
        pass
    assert reg.events("span")[-1]["name"] == "after"


def test_disabled_registry_has_zero_side_effects():
    reg = obs.Registry(enabled=False)
    c = reg.counter("x")
    assert c is reg.gauge("y") is reg.distribution("z")
    c.inc(10)
    reg.gauge("y").set(1.0)
    reg.distribution("z").observe(5.0)
    reg.event("request", batch=8)
    sp = reg.span("s")
    assert sp is reg_mod._NULL_SPAN
    with sp as s:
        assert s.sync("v") == "v"
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "distributions": {}}
    assert reg.events() == []
    assert reg.distribution("z").percentile(99) == 0.0


def test_global_override_toggles_instrumentation():
    assert not obs.enabled()
    obs.counter("ignored").inc()
    with obs.override(True) as reg:
        assert obs.enabled()
        obs.counter("seen").inc()
        assert reg.counter("seen").value == 1
    assert not obs.enabled()
    assert "ignored" not in obs.default_registry().snapshot()["counters"]
    obs.default_registry().reset()


def test_jsonl_sink_round_trip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    reg = obs.Registry()
    reg.add_sink(obs.JsonlSink(path))
    reg.event("request", batch=np.int64(8), latency_ms=np.float32(1.5),
              ids=torch.tensor([3, 4], dtype=torch.int32))
    reg.event("refresh", drift=float("nan"), arr=np.arange(3),
              norm=torch.tensor(2.5))
    reg.reset()                                          # closes the sink
    evs = obs.read_jsonl(path)
    assert [e["kind"] for e in evs] == ["request", "refresh"]
    assert evs[0]["batch"] == 8 and evs[0]["latency_ms"] == 1.5
    assert evs[0]["ids"] == [3, 4]
    assert evs[1]["drift"] is None
    assert evs[1]["arr"] == [0, 1, 2] and evs[1]["norm"] == 2.5
    for line in open(path):
        json.loads(line)
    for x in (np.float32(np.inf), [np.int8(3), (1, 2)], {"a": np.bool_(1)}):
        assert obs.jsonable(x) == jobs.jsonable(x)


def test_text_report_lists_every_metric_kind():
    reg = obs.Registry()
    reg.counter("engine.requests").inc(3)
    reg.gauge("probe.recall_at_k", k=10).set(0.93)
    reg.distribution("engine.latency_ms").observe(2.0)
    rep = obs.report(reg)
    for needle in ("engine.requests", "probe.recall_at_k{k=10}",
                   "engine.latency_ms", "p99"):
        assert needle in rep
    assert obs.text_report(obs.Registry()) == "(no metrics recorded)"


def test_recall_probe_sampling_cadence():
    probe = obs.RecallProbe(np.zeros((4, DIM), np.float32),
                            np.zeros((4, 10), np.int64), k=10, every=3)
    calls = []
    for i in range(7):
        probe.maybe_run(lambda q: (calls.append(i),
                                   np.zeros((4, 10), np.int64))[1])
    assert calls == [0, 3, 6]
    with pytest.raises(ValueError, match="need k=10"):
        obs.RecallProbe(np.zeros((1, DIM)), np.zeros((1, 5)), k=10)


def _cross_subspace_delta(scale: float):
    """Planes that straddle subspaces: the rotation absorbs them, the
    codebooks cannot; at large angles recall collapses."""
    sub = DIM // SUB
    pi = np.arange(0, DIM // 2)
    pj = pi + DIM // 2
    assert not np.any(pi // sub == pj // sub)
    theta = np.full(pi.shape, scale, np.float32)
    return (jrot.GivensDelta(pi=jnp.asarray(pi), pj=jnp.asarray(pj),
                             theta=jnp.asarray(theta)),
            rotations.GivensDelta(pi=torch.from_numpy(pi),
                                  pj=torch.from_numpy(pj),
                                  theta=torch.from_numpy(theta)))


def test_refresh_health_matches_jax():
    R = np.linalg.qr(np.random.RandomState(0).randn(DIM, DIM))[0].astype(
        np.float32)
    jd, td = _cross_subspace_delta(1e-2)
    jreg, treg = jobs.Registry(), obs.Registry()
    want = jmaintain.refresh_health(jnp.asarray(R), jd, registry=jreg)
    got = maintain.refresh_health(torch.from_numpy(R), td, registry=treg)
    assert got["delta_norm"] == pytest.approx(want["delta_norm"], rel=1e-6)
    assert got["orthogonality_drift"] == pytest.approx(
        want["orthogonality_drift"], abs=1e-6)
    assert got["orthogonality_drift"] < 1e-4
    snap = treg.snapshot()
    assert snap["counters"]["refresh.count"] == 1
    assert snap["gauges"]["refresh.delta_norm"] == got["delta_norm"]
    assert treg.events("refresh")[0]["delta_norm"] == got["delta_norm"]
    # a delta without any pairs: norm 0
    empty = maintain.refresh_health(torch.from_numpy(R),
                                    rotations.identity_delta(), registry=treg)
    assert empty["delta_norm"] == 0.0


@pytest.fixture(scope="module")
def serving():
    X = np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), 400, DIM))
    R = np.linalg.qr(np.random.RandomState(1).randn(DIM, DIM))[0].astype(
        np.float32)
    Q = np.asarray(jsynth.sift_like(jax.random.PRNGKey(2), 16, DIM))
    jindex = jsearch.make("ivf").build(
        jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(R),
        jsearch.SearchConfig(**CFG)).index
    arrays = dict(R=jindex.R, centroids=jindex.centroids,
                  codebooks=jindex.codebooks, codes=jindex.codes,
                  ids=jindex.ids, list_offsets=jindex.list_offsets,
                  block_size=jindex.block_size)
    tstate = convert.adc_state_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, fused=False,
        device="cpu")
    return X, R, Q, jsearch.FlatADC.attach(jindex), tstate


def test_engine_stats_percentiles_and_window(serving):
    _, _, Q, jstate, tstate = serving
    engines = (jsearch.Engine(jsearch.make("flat_adc"), jstate, k=10,
                              min_bucket=4, history=128),
               search.Engine(search.make("flat_adc"), tstate, k=10,
                             min_bucket=4, history=128))
    for engine in engines:
        for b in (3, 7, 16, 5):
            engine.search(Q[:b])
    jst, st = engines[0].stats(), engines[1].stats()
    assert st["requests"] == 4 and st["queries"] == 31
    assert st["latency_ms_p50"] > 0.0
    assert st["latency_ms_p99"] >= st["latency_ms_p95"] >= st["latency_ms_p50"]
    assert st["latency_ms_max"] >= st["latency_ms_p99"]
    assert st["window"] == jst["window"] == {
        "size": 4, "capacity": 128,
        "scope": "latency/scanned/pad aggregates"}
    assert st["pad_waste_mean"] == pytest.approx(jst["pad_waste_mean"])
    assert st["scanned_rows_mean"] == jst["scanned_rows_mean"]
    assert set(st) == set(jst)
    reqs, jreqs = engines[1].requests, engines[0].requests
    assert [r["batch"] for r in reqs] == [3, 7, 16, 5]
    assert set(reqs[0]) == set(jreqs[0])
    assert [r["compiled"] for r in reqs] == [r["compiled"] for r in jreqs]


def test_engine_with_obs_enabled_changes_nothing(serving):
    """The global registry on: the same executables and counters, and the
    refresh health recorded on the global registry."""
    _, _, Q, _, tstate = serving
    _, td = _cross_subspace_delta(1e-3)

    def drive(engine):
        for b in (3, 7, 3, 16):
            engine.search(Q[:b])
        engine.refresh(td)
        for b in (3, 7, 16):
            engine.search(Q[:b])
        return engine.stats()

    base = drive(search.Engine(search.make("flat_adc"), tstate, k=10,
                               min_bucket=4))
    with obs.override(True):
        inst = drive(search.Engine(search.make("flat_adc"), tstate, k=10,
                                   min_bucket=4))
        snap = obs.default_registry().snapshot()
        assert snap["gauges"]["refresh.orthogonality_drift"] < 1e-3
        assert snap["gauges"]["refresh.delta_norm"] > 0.0
    obs.default_registry().reset()
    assert inst["compiles"] == base["compiles"] == 3
    assert inst["executables"] == base["executables"]
    assert inst["requests"] == base["requests"]


def test_recall_probe_catches_a_bad_rotation(serving):
    X, R, Q, _, tstate = serving
    probe = obs.RecallProbe.from_exact(torch.tensor(X), torch.tensor(R), Q,
                                       k=10, every=4, device="cpu")
    truth = np.argsort(-(Q @ X.T), axis=1)[:, :10]
    np.testing.assert_array_equal(probe.truth, truth)
    engine = search.Engine(search.make("flat_adc"), tstate, k=10,
                           min_bucket=4, probe=probe)
    engine.search(Q)                          # first request: the baseline
    base = probe.last
    assert base is not None and base > 0.5
    assert engine.stats()["recall_probe"] == {"k": 10, "recall": base,
                                              "every": 4}
    _, bad = _cross_subspace_delta(1.0)
    engine.refresh(bad)
    for _ in range(4):
        engine.search(Q[:4])
    assert probe.truth.shape == (16, 10)
    assert probe.last < base - 0.2, f"missed the bad rotation: {base}"


def test_profile_trace_and_record_function(tmp_path):
    """``profile=True``: spans enter ``torch.profiler.record_function`` and
    ``trace(dir)`` writes a Chrome trace holding them; with profiling off
    ``trace`` is a no-op."""
    reg = obs.Registry(profile=True)
    with reg.trace(str(tmp_path)):
        with reg.span("engine.search"):
            torch.ones(8).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "engine.search"
               for ev in doc["traceEvents"])
    quiet = tmp_path / "off"
    with obs.Registry().trace(str(quiet)):
        pass
    assert not quiet.exists()
