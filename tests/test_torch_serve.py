"""The port's serving front end (``repro_torch.serve``) on the CPU: the JAX
package's ``tests/test_serve.py`` ported test for test, and held against
the JAX package.

Both namespaces' indexes are built by the JAX package (its threefry draws
cannot be reproduced) and carried across with
``convert.adc_state_from_numpy(fused=True)``, so both packages serve the
very same codes; queries are the JAX draws as numpy. The queueing runs on
a ``VirtualClock``, so it is deterministic.

Parity: the queue and the SLO controller are pure arithmetic and must
agree exactly; the Frontends are driven with ``advance=None`` (measured
service times never reach the clock) and EWMAs seeded by ``observe``,
with budgets far from any decision boundary, and must serve equal ids
(scores to 1e-5), rungs and counters. The state handed to
``create_namespace`` must be left bit-equal by serving, refreshes and
churn (it is handed to several Frontends).
"""
from __future__ import annotations

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import rotations as jrot
from repro import search as jsearch
from repro import serve as jserve
from repro.data import synthetic as jsynth
from repro.serve import frontend as jfrontend
from repro.serve.queue import BatchQueue as JBatchQueue
from repro.serve.queue import make_ticket as jmake_ticket
from repro_torch import convert, rotations, search, serve
from repro_torch.bench import serve_load
from repro_torch.serve import frontend as tfrontend
from repro_torch.serve.queue import BatchQueue, make_ticket

DIM, SUB, K, L, BS = 16, 4, 16, 8, 8
N = 1500
CFG = dict(num_lists=L, subspaces=SUB, codewords=K, block_size=BS, nprobe=4,
           fused_refresh=True)
TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("requests", "queries", "compiles", "executables", "refreshes",
            "lut_hits", "lut_misses", "lut_invalidations", "lut_evictions",
            "lut_epoch", "lut_cached_rows")
FE_COUNTERS = ("admitted", "flushes", "batches", "served", "sheds",
               "maintenance_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tiny shapes: the suite runs in
    several worker processes on one machine, and a thread a core in each
    slows these searches a hundredfold (measured: a bucket-8 search 2–3 ms
    alone, 350–800 ms with six workers), past the latency budgets the SLO
    tests serve under."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _state_arrays(state) -> dict:
    """A JAX fused ADCState as the dict ``convert.adc_state_from_numpy``
    takes."""
    index = state.index
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size, rot=np.asarray(state.rot),
                wacc=np.asarray(state.wacc), qdelta=np.asarray(state.qdelta))


@pytest.fixture(scope="module")
def both():
    """The JAX test's two namespaces: each JAX state, its port copy and its
    16 queries (numpy)."""
    js = jsearch.make("ivf")
    out = {}
    for i, name in enumerate(("alpha", "beta")):
        X = jsynth.sift_like(jax.random.PRNGKey(10 * i), N, DIM)
        R = jrot.random_rotation(jax.random.PRNGKey(10 * i + 1), DIM)
        jstate = js.build(jax.random.PRNGKey(10 * i + 2), X, R,
                          jsearch.SearchConfig(**CFG))
        tstate = convert.adc_state_from_numpy(
            _state_arrays(jstate), fused=True, nprobe=CFG["nprobe"],
            device="cpu")
        Q = np.asarray(jsynth.sift_like(
            jax.random.PRNGKey(10 * i + 3), 16, DIM))
        out[name] = (jstate, tstate, Q)
    return out


@pytest.fixture(scope="module")
def corpus(both):
    """The port's side, shaped as the JAX test's ``corpus`` fixture."""
    return search.make("ivf"), {name: (t, Q)
                                for name, (_, t, Q) in both.items()}


def _frontend(corpus, **kw):
    s, states = corpus
    clk = serve.VirtualClock()
    fe = serve.Frontend(slo_ms=kw.pop("slo_ms", 200.0),
                        clock=clk.now, advance=clk.advance,
                        lut_budget_rows=kw.pop("lut_budget_rows", 256))
    for name, (state, Q) in states.items():
        fe.create_namespace(name, s, state, k=10, warmup_queries=Q[:2],
                            **kw)
    return clk, fe, states


def _cross_delta(R: torch.Tensor, seed: int):
    """A full-width GCD delta on a seeded G: its pairs cross subspaces."""
    G = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (DIM, DIM)).astype(np.float32))
    learner = rotations.make("gcd")
    _, delta = learner.update(learner.init_from(R), G, 1e-3)
    return delta


def _tensors(obj, prefix: str = "") -> dict:
    """Every tensor reachable through a state's dataclass fields, by
    path."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    return out


# -- queue semantics --------------------------------------------------------
def test_queue_deadline_flush():
    clk = serve.VirtualClock()
    q = BatchQueue(admission_ms=5.0, max_admit=4, clock=clk.now)
    q.push(make_ticket("a", None, k=10, nprobe=None, slo_ms=50,
                       arrival=clk.now()))
    assert not q.due()                       # window still open
    assert q.take() == []
    clk.advance(0.004)
    q.push(make_ticket("a", None, k=10, nprobe=None, slo_ms=50,
                       arrival=clk.now()))
    assert not q.due()
    clk.advance(0.0015)                      # oldest passes 5 ms
    assert q.due()
    batch = q.take()
    assert len(batch) == 2                   # both ride the same bucket
    assert batch[0].waited_ms >= 5.0 > batch[1].waited_ms
    assert q.depth == 0 and not q.due()


def test_queue_full_bucket_flushes_immediately():
    clk = serve.VirtualClock()
    q = BatchQueue(admission_ms=1e6, max_admit=3, clock=clk.now)
    for _ in range(7):
        q.push(make_ticket("a", None, k=10, nprobe=None, slo_ms=50,
                           arrival=clk.now()))
    assert q.due()                           # full despite infinite window
    assert len(q.take()) == 3
    assert len(q.take()) == 3
    assert q.take() == []                    # 1 left, window open again
    assert q.depth == 1


def test_queue_deadline_zero_degenerates_to_immediate():
    clk = serve.VirtualClock()
    q = BatchQueue(admission_ms=0.0, max_admit=8, clock=clk.now)
    q.push(make_ticket("a", None, k=10, nprobe=None, slo_ms=50,
                       arrival=clk.now()))
    assert q.due()                           # no batching delay at all
    assert len(q.take()) == 1


def test_queue_empty_drain():
    q = BatchQueue(clock=serve.VirtualClock().now)
    assert list(q.drain()) == []
    assert q.take() == []
    assert q.next_deadline() is None


# -- SLO controller ---------------------------------------------------------
def test_slo_controller_sheds_and_recovers():
    c = serve.SLOController(ladder=(2, 8, 32), safety=1.0, ewma=0.5)
    for rung, ms in ((2, 1.0), (8, 4.0), (32, 16.0)):
        c.observe(8, rung, ms)
    assert c.choose(100.0, 8) == 32          # ample budget → top rung
    assert c.choose(10.0, 8) == 8            # mid fits, top doesn't
    assert c.choose(2.0, 8) == 2
    assert c.choose(0.5, 8) == 2             # nothing fits → floor
    # backlog feedforward: 2 waves of queued work halve the usable budget
    assert c.choose(20.0, 8, backlog=8) == 8
    assert c.choose(40.0, 8, backlog=8) == 32
    assert c.floors == 1 and c.sheds >= 3
    # EWMA folds new evidence: top rung speeding up re-enables it
    for _ in range(8):
        c.observe(8, 32, 2.0)
    assert c.choose(10.0, 8) == 32


def test_slo_unknown_cell_falls_to_floor():
    c = serve.SLOController(ladder=(2, 8))
    assert c.choose(1e9, 16) == 2            # no EWMA yet → serve at floor


# -- serving through the frontend ------------------------------------------
def test_ragged_k_nprobe_mix_one_bucket_matches_direct(corpus):
    """One flush holding mixed k and nprobe serves every request exactly
    as a direct Engine call with the same parameters would."""
    s, states = corpus
    clk, fe, _ = _frontend(corpus, admission_ms=2.0, max_admit=8)
    state, Q = states["alpha"]
    want_engine = search.Engine(s, state, k=10)
    mix = [dict(k=3, nprobe=2), dict(k=10, nprobe=2), dict(k=3, nprobe=8),
           dict(k=7, nprobe=None), dict(k=10, nprobe=None)]
    tickets = [fe.submit("alpha", Q[i], **m) for i, m in enumerate(mix)]
    clk.advance(0.003)
    fe.poll()
    assert all(t.done for t in tickets)
    for i, (t, m) in enumerate(zip(tickets, mix)):
        want = want_engine.search(Q[i:i + 1], k=m["k"], nprobe=m["nprobe"])
        np.testing.assert_array_equal(t.result.ids.numpy(),
                                      want.ids.numpy()[0])
        np.testing.assert_allclose(t.result.scores.numpy(),
                                   want.scores.numpy()[0], atol=1e-4)
        assert t.result.ids.shape == (m["k"],)


def test_batch_composition_invariance(corpus):
    """A request's results don't depend on which co-riders shared its
    bucket."""
    s, states = corpus
    state, Q = states["alpha"]
    clk, fe, _ = _frontend(corpus, admission_ms=1.0, max_admit=8)
    solo = fe.submit("alpha", Q[0], nprobe=4)
    clk.advance(0.002)
    fe.poll()
    clk2, fe2, _ = _frontend(corpus, admission_ms=1.0, max_admit=8)
    crowd = [fe2.submit("alpha", Q[i], nprobe=4) for i in (3, 0, 5, 7)]
    clk2.advance(0.002)
    fe2.poll()
    np.testing.assert_array_equal(solo.result.ids.numpy(),
                                  crowd[1].result.ids.numpy())


def test_adaptive_nprobe_stays_on_precompiled_ladder(corpus):
    """SLO adaptation only ever serves ladder rungs, and switching rungs
    never makes a new executable after warmup."""
    clk, fe, states = _frontend(corpus, admission_ms=1.0, max_admit=4,
                                nprobe_ladder=(2, 4, 8), slo_ms=500.0)
    ns = fe.namespaces.get("alpha")
    warm = ns.engine.stats()["compiles"]
    _, Q = states["alpha"]
    served = []
    for i in range(12):
        t = fe.submit("alpha", Q[i % len(Q)],
                      slo_ms=500.0 if i % 3 else 1e-6)  # force floor sheds
        clk.advance(0.002)
        fe.poll()
        assert t.done
        served.append(t.nprobe_served)
    assert set(served) <= {2, 4, 8}
    assert 2 in served and 8 in served        # both ends exercised
    assert ns.engine.stats()["compiles"] == warm
    assert ns.slo.sheds >= 1


def test_default_warmup_synthesized(corpus):
    """create_namespace without warmup_queries still makes every (bucket,
    rung) cell and seeds the SLO model from synthetic Gaussian rows at the
    state's rotation width; warmup_queries=() opts out."""
    s, states = corpus
    state, Q = states["alpha"]
    clk = serve.VirtualClock()
    fe = serve.Frontend(clock=clk.now, advance=clk.advance,
                        lut_budget_rows=256, slo_ms=200.0)
    ns = fe.create_namespace("auto", s, state, k=10, nprobe_ladder=(2, 8),
                             admission_ms=1.0, max_admit=4)
    assert ns.warm_compiles > 0
    assert ns.slo.stats()["cells"]            # EWMA seeded per (bucket,rung)
    warm = ns.engine.stats()["compiles"]
    t = fe.submit("auto", Q[0], slo_ms=1e9)
    clk.advance(0.002)
    fe.poll()
    assert t.done and t.nprobe_served == 8    # budget allows the top rung
    assert ns.engine.stats()["compiles"] == warm

    cold = fe.create_namespace("cold", s, state, k=10,
                               warmup_queries=())
    assert cold.warm_compiles == 0


def test_namespace_isolation_refresh(corpus):
    """A cross-subspace refresh on alpha invalidates only alpha's LUT
    cache; beta's cache, epoch and executables are untouched."""
    s, states = corpus
    clk, fe, _ = _frontend(corpus, admission_ms=0.0, max_admit=4)
    Qa, Qb = states["alpha"][1], states["beta"][1]
    for i in range(4):
        fe.submit("alpha", Qa[i])
        fe.submit("beta", Qb[i])
        fe.poll()
    ea = fe.namespaces.get("alpha").engine
    eb = fe.namespaces.get("beta").engine
    sb0 = eb.stats()
    assert sb0["lut_cached_rows"] > 0
    ea.refresh(_cross_delta(ea.state.index.R, seed=5))
    sa, sb = ea.stats(), eb.stats()
    assert sa["lut_invalidations"] == 1 and sa["lut_epoch"] == 1
    assert sb["lut_invalidations"] == 0 and sb["lut_epoch"] == 0
    assert sb["lut_cached_rows"] == sb0["lut_cached_rows"]
    # beta still serves on warm caches: no new executable, all LUT hits
    t = fe.submit("beta", Qb[0])
    fe.poll()
    assert t.done
    sb2 = eb.stats()
    assert sb2["compiles"] == sb0["compiles"]
    assert sb2["lut_misses"] == sb["lut_misses"]


def test_lut_budget_split_and_evictions(corpus):
    """The global LUT budget splits evenly per namespace; a hot tenant
    churning distinct queries evicts only its own rows."""
    s, states = corpus
    clk, fe, _ = _frontend(corpus, admission_ms=0.0, max_admit=4,
                           lut_budget_rows=8)
    ea = fe.namespaces.get("alpha").engine
    eb = fe.namespaces.get("beta").engine
    assert ea.lut_cache_rows == 4 and eb.lut_cache_rows == 4
    _, Qb = states["beta"]
    for i in range(3):
        fe.submit("beta", Qb[i])
        fe.poll()
    rows_b = eb.stats()["lut_cached_rows"]
    rng = np.random.default_rng(0)
    for _ in range(10):                      # alpha hammers distinct queries
        fe.submit("alpha", rng.standard_normal(DIM).astype(np.float32))
        fe.poll()
    assert ea.stats()["lut_evictions"] > 0
    assert ea.stats()["lut_cached_rows"] <= 4
    assert eb.stats()["lut_cached_rows"] == rows_b     # beta untouched
    assert eb.stats()["lut_evictions"] == 0


def test_namespace_lifecycle_resplit(corpus):
    s, states = corpus
    clk = serve.VirtualClock()
    fe = serve.Frontend(clock=clk.now, advance=clk.advance,
                        lut_budget_rows=100)
    state, Q = states["alpha"]
    fe.create_namespace("a", s, state, k=10)
    assert fe.namespaces.get("a").engine.lut_cache_rows == 100
    fe.create_namespace("b", s, state, k=10)
    assert fe.namespaces.get("a").engine.lut_cache_rows == 50
    fe.drop_namespace("b")
    assert fe.namespaces.get("a").engine.lut_cache_rows == 100
    with pytest.raises(KeyError, match="unknown namespace"):
        fe.namespaces.get("b")
    with pytest.raises(ValueError, match="already exists"):
        fe.create_namespace("a", s, state, k=10)


def test_churn_ticks_in_idle_slots(corpus):
    """Idle polls run churn maintenance; staged rows flush through ticks
    without a new executable, and stay searchable."""
    s, states = corpus
    clk, fe, _ = _frontend(corpus, admission_ms=1.0, max_admit=4,
                           churn={"staging_rows": 64, "flush_at": 0.25})
    ns = fe.namespaces.get("alpha")
    _, Q = states["alpha"]
    t = fe.submit("alpha", Q[0])
    clk.advance(0.002)
    fe.poll()
    assert t.done
    compiles = ns.engine.stats()["compiles"]
    # in-distribution adds at double magnitude: distinctive PQ codes, so
    # each new row is its own query's strong match
    new = 2.0 * np.asarray(jsynth.sift_like(jax.random.PRNGKey(9), 32, DIM))
    new_ids = np.arange(10_000, 10_032, dtype=np.int32)
    ns.churn.add(torch.from_numpy(new), torch.from_numpy(new_ids))
    before = fe.stats()["maintenance_ticks"]
    fe.poll()                                # idle → maintenance tick
    assert fe.stats()["maintenance_ticks"] == before + 1
    assert ns.engine.obs.counter("churn.flushes").value >= 1
    assert ns.engine.stats()["compiles"] == compiles
    # flushed rows are searchable (probe every list so only ADC ranks)
    t2 = fe.submit("alpha", new[0], nprobe=L)
    clk.advance(0.002)
    fe.poll()
    assert 10_000 in t2.result.ids.numpy()


def test_drain_and_ticket_errors(corpus):
    clk, fe, states = _frontend(corpus, admission_ms=1e6, max_admit=64)
    _, Q = states["alpha"]
    tickets = [fe.submit("alpha", Q[i]) for i in range(3)]
    assert fe.poll() == []                   # window open for a long time
    assert not tickets[0].done
    with pytest.raises(ValueError, match="still in flight"):
        _ = tickets[0].latency_ms
    done = fe.drain()                        # shutdown flush ignores window
    assert len(done) == 3 and all(t.done for t in tickets)
    with pytest.raises(ValueError, match="query row"):
        fe.submit("alpha", Q[:2])
    with pytest.raises(KeyError, match="unknown namespace"):
        fe.submit("nope", Q[0])


# -- parity with the JAX package --------------------------------------------
def test_queue_and_slo_match_jax():
    """One ticket sequence through a BatchQueue of each package, and one
    observation and decision sequence through an SLOController of each:
    equal flushes, queue waits, decisions, sheds, floors and stats()."""
    rng = np.random.default_rng(3)
    flushes = []
    for mod_q, mod_t, mod_c in ((JBatchQueue, jmake_ticket, jserve),
                                (BatchQueue, make_ticket, serve)):
        clk = mod_c.VirtualClock()
        q = mod_q(admission_ms=3.0, max_admit=5, clock=clk.now)
        log = []
        steps = np.random.default_rng(3)
        for i in range(60):
            for _ in range(int(steps.integers(0, 4))):
                q.push(mod_t("a", i, k=10, nprobe=None, slo_ms=50.0,
                             arrival=clk.now()))
            clk.advance(float(steps.exponential(0.0015)))
            log.append(("due", q.due(), q.next_deadline(), q.depth))
            while (batch := q.take()):
                log.append(("take", [(t.query, t.waited_ms) for t in batch]))
        log.append(("drain", [[(t.query, t.waited_ms) for t in b]
                              for b in q.drain()]))
        flushes.append(log)
    assert flushes[0] == flushes[1]
    assert any(e[0] == "take" for e in flushes[0])

    obs_seq = [(int(b), int(r), float(ms)) for b, r, ms in zip(
        rng.choice([4, 8], 40), rng.choice([2, 8, 32], 40),
        rng.uniform(0.5, 20.0, 40))]
    asks = [(float(bud), int(b), int(bl)) for bud, b, bl in zip(
        rng.uniform(-5.0, 60.0, 80), rng.choice([4, 8, 16], 80),
        rng.integers(0, 20, 80))]
    out = []
    for mod in (jserve, serve):
        c = mod.SLOController(ladder=(8, 2, 32), safety=1.3, ewma=0.3)
        picks = []
        for j, (bud, b, bl) in enumerate(asks):
            if j < len(obs_seq):
                c.observe(*obs_seq[j])
            picks.append(c.choose(bud, b, backlog=bl))
        c.observe(8, 2, float("nan"))        # dropped by both
        out.append((picks, c.decisions, c.sheds, c.floors, c.stats()))
    assert out[0] == out[1]
    assert len(set(out[0][0])) == 3 and out[0][3] > 0


def _jax_cross_delta(R, seed: int):
    G = jax.random.normal(jax.random.PRNGKey(seed), (DIM, DIM))
    learner = jrot.make("gcd")
    _, delta = learner.update(learner.init_from(R), G, 1e-3,
                              jax.random.PRNGKey(seed + 1))
    return delta


def test_frontend_matches_jax(both):
    """One submit sequence through a Frontend of each package (alpha
    adaptive on (2, 4, 8) with a ChurnController, beta fixed; explicit
    nprobe and k overrides; budgets that fit every rung, all but the top,
    only the floor, or nothing), one cross-subspace refresh of alpha (the
    JAX delta handed to both) and idle ticks: equal ids, scores to 1e-5,
    rungs served, queue waits, front-end counters and each Engine's
    counters."""
    runs = []
    for pkg in ("jax", "torch"):
        mod = jserve if pkg == "jax" else serve
        s = jsearch.make("ivf") if pkg == "jax" else search.make("ivf")
        clk = mod.VirtualClock()
        fe = mod.Frontend(slo_ms=100.0, clock=clk.now, advance=None,
                          lut_budget_rows=24)
        for name, (jstate, tstate, _) in both.items():
            alpha = name == "alpha"
            fe.create_namespace(
                name, s, jstate if pkg == "jax" else tstate, k=10,
                nprobe_ladder=(2, 4, 8) if alpha else None,
                admission_ms=1.0, max_admit=4,
                churn={"staging_rows": 16} if alpha else None,
                warmup_queries=())
        slo = fe.namespaces.get("alpha").slo
        for bucket in (4, 8):
            for rung, ms in ((2, 1.0), (4, 1e5), (8, 1e6)):
                slo.observe(bucket, rung, ms)
        # measured service times (which differ between the packages) then
        # move no prediction across a decision
        slo.ewma = 1e-9
        rng = np.random.default_rng(7)
        tickets = []
        for step in range(30):
            if step == 15:
                eng = fe.namespaces.get("alpha").engine
                d = _jax_cross_delta(both["alpha"][0].index.R, 40)
                if pkg == "torch":
                    d = rotations.GivensDelta(
                        pi=torch.from_numpy(np.array(d.pi)),
                        pj=torch.from_numpy(np.array(d.pj)),
                        theta=torch.from_numpy(np.array(d.theta)))
                eng.refresh(d)
            for _ in range(int(rng.integers(0, 4))):
                name = ("alpha", "beta")[int(rng.integers(0, 2))]
                Q = both[name][2]
                kw = {}
                if rng.random() < 0.2:
                    kw["k"] = int(rng.choice([3, 7]))
                if name == "alpha":
                    kw["slo_ms"] = float(rng.choice([1e9, 5e5, 500.0, -1.0]))
                    if rng.random() < 0.15:
                        kw["nprobe"] = 2
                tickets.append(fe.submit(name, Q[int(rng.integers(0, 16))],
                                         **kw))
            clk.advance(float(rng.choice([0.0, 0.0005, 0.002])))
            fe.poll()
        fe.drain()
        assert all(t.done for t in tickets)
        st = fe.stats()
        runs.append(dict(
            ids=[np.asarray(t.result.ids) for t in tickets],
            scores=[np.asarray(t.result.scores) for t in tickets],
            rungs=[t.nprobe_served for t in tickets],
            waited=[t.waited_ms for t in tickets],
            counters={c: st[c] for c in FE_COUNTERS},
            engines={nm: {c: st["namespaces"][nm][c] for c in COUNTERS}
                     for nm in ("alpha", "beta")},
            slo={c: st["namespaces"]["alpha"]["slo"][c]
                 for c in ("decisions", "sheds", "floors")}))
    j, t = runs
    for a, b in zip(j["ids"], t["ids"]):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(j["scores"], t["scores"]):
        np.testing.assert_allclose(b, a, **TOL)
    assert t["rungs"] == j["rungs"] and t["waited"] == j["waited"]
    assert t["counters"] == j["counters"] and t["engines"] == j["engines"]
    assert t["slo"] == j["slo"]
    assert {2, 4, 8} <= set(j["rungs"])      # every regime was exercised
    assert j["engines"]["alpha"]["lut_invalidations"] == 1
    assert j["counters"]["maintenance_ticks"] > 0


def test_served_state_left_bit_equal(both):
    """Hazard: the benchmark hands one built state to five Frontends. A
    cell with refreshes and idle ticks, and a Frontend that stages,
    flushes and refreshes, leave the state given to create_namespace
    bit-equal to a copy taken before."""
    corpora = {name: dict(state=t, pool=Q,
                          truth=np.zeros((16, 10), dtype=np.int64))
               for name, (_, t, Q) in both.items()}
    before = {name: {p: v.clone() for p, v in _tensors(c["state"]).items()}
              for name, c in corpora.items()}
    snap = {name: copy.copy(c["state"]) for name, c in corpora.items()}
    trace = serve_load._arrival_trace(np.random.default_rng(42),
                                      requests=120, rate_qps=4000.0,
                                      pool_size=16)
    cell = serve_load._run_cell(
        search.make("ivf"), corpora, trace, ladder=(2, 4), fixed_nprobe=None,
        slo_ms=50.0, admission_ms=1.0, max_admit=4, dim=DIM,
        refresh_every=40, warm_frac=0.3)
    assert cell["alpha_refreshes"] == 3 and cell["maintenance_ticks"] >= 1

    clk = serve.VirtualClock()
    fe = serve.Frontend(clock=clk.now, advance=clk.advance)
    ns = fe.create_namespace("alpha", "ivf", corpora["alpha"]["state"],
                             k=10, churn={"staging_rows": 16,
                                          "flush_at": 0.25},
                             warmup_queries=())
    ns.churn.add(torch.from_numpy(2.0 * corpora["beta"]["pool"][:8]),
                 torch.arange(20_000, 20_008, dtype=torch.int32))
    fe.poll()                                   # idle tick: a flush
    ns.engine.refresh(_cross_delta(ns.engine.state.index.R, seed=2))
    fe.submit("alpha", corpora["alpha"]["pool"][0])
    fe.drain()
    assert ns.engine.obs.counter("churn.flushes").value == 1

    for name, c in corpora.items():
        assert c["state"] is both[name][1]
        now = _tensors(c["state"])
        assert now.keys() == before[name].keys()
        for p, v in now.items():
            assert torch.equal(v, before[name][p]), (name, p)
        for f in ("max_blocks", "nprobe", "lut_dtype", "staging"):
            assert getattr(c["state"], f) == getattr(snap[name], f)


def test_synth_warmup_queries_equal_bytes(both):
    jstate, tstate, _ = both["alpha"]
    a = jfrontend._synth_warmup_queries(jstate)
    b = tfrontend._synth_warmup_queries(tstate)
    assert a.dtype == b.dtype == np.float32 and a.shape == (8, DIM)
    assert a.tobytes() == b.tobytes()
    assert tfrontend._synth_warmup_queries(None).shape == (0, 0)
