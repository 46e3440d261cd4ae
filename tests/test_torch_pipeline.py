"""The port's overlapped training loop on the CPU: gradient accumulation
(``training.train_state``), checkpoints (``training.checkpoint``), the
prefetching input pipeline (``data.pipeline``), ``pipeline.LiveIndexLoop``
and ``bench.train_e2e``, against the JAX package where it has a
counterpart.

Parameters and indexes are carried across as numpy arrays; the deltas the
loop replays are the JAX learner's, converted, so both Engines absorb the
very same rotations. On the card the pipeline builds its prefetched batch
on a side stream (``data/pipeline.py``); on the CPU it builds it on the
worker thread, and the stream must be bit-identical either way.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import churn as jchurn
from repro import quant as jquant
from repro import rotations as jrot
from repro import search as jsearch
from repro.core import givens as jgivens
from repro.data import synthetic as jsynth
from repro.index import ivf as jivf
from repro.pipeline import LiveIndexLoop as JLiveIndexLoop
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_state as jts
from repro_torch import churn, convert, obs, pipeline, rotations, search
from repro_torch.bench import train_e2e
from repro_torch.data import pipeline as pipe_lib
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

DIM, D, K, L, BS = 16, 4, 16, 8, 8
N = 1500


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- gradient accumulation ----------------------------------------------------


def _problem(seed: int = 0):
    """A small regression with a tanh layer: numpy params and one batch."""
    rng = np.random.RandomState(seed)
    params = {"w1": rng.randn(DIM, 2 * DIM).astype(np.float32) * 0.3,
              "w2": rng.randn(2 * DIM, DIM).astype(np.float32) * 0.3,
              "b": rng.randn(DIM).astype(np.float32) * 0.1}
    x = rng.randn(32, DIM).astype(np.float32)
    y = rng.randn(32, DIM).astype(np.float32)
    return params, x, y


def _torch_loss(p, x, y):
    h = torch.tanh(x @ p["w1"]) @ p["w2"] + p["b"]
    return torch.mean(torch.sum((h - y) ** 2, dim=-1))


def _jax_loss(p, x, y):
    h = jnp.tanh(x @ p["w1"]) @ p["w2"] + p["b"]
    return jnp.mean(jnp.sum((h - y) ** 2, axis=-1))


def _torch_step(params_np, x, y, A: int):
    ocfg = opt_lib.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                                   accum_steps=A)
    params = {k: _t(v).requires_grad_(True) for k, v in params_np.items()}
    state = ts.init_state(None, params, ocfg)
    state, m = ts.make_train_step(_torch_loss, ocfg)(state, _t(x), _t(y))
    return state, m


@pytest.mark.parametrize("A", [2, 4])
def test_accum_steps_equal_loss_grads_and_step(A):
    """accum_steps 1 against A: the same loss, gradient norm and updated
    parameters (1e-5)."""
    p, x, y = _problem()
    s1, m1 = _torch_step(p, x, y, 1)
    sa, ma = _torch_step(p, x, y, A)
    assert abs(float(ma["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
        float(m1["loss"]))
    assert abs(float(ma["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 * \
        float(m1["grad_norm"])
    for k in p:
        np.testing.assert_allclose(sa.params[k].detach().numpy(),
                                   s1.params[k].detach().numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_accum_steps_match_jax_accumulated_step():
    """accum_steps = 4 against the JAX package's accumulated step on the
    same parameters and batch: loss, gradient norm and the step (1e-5)."""
    p, x, y = _problem(1)
    sa, ma = _torch_step(p, x, y, 4)
    jcfg = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                                accum_steps=4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = jts.init_state(jax.random.PRNGKey(0), jp, jcfg)
    jstate, jm = jax.jit(jts.make_train_step(_jax_loss, jcfg))(
        jstate, jnp.asarray(x), jnp.asarray(y))
    assert abs(float(ma["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert abs(float(ma["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * \
        float(jm["grad_norm"])
    for k in p:
        np.testing.assert_allclose(sa.params[k].detach().numpy(),
                                   np.asarray(jstate.params[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_accum_steps_run_one_microbatch_graph_at_a_time():
    """The loss sees A microbatches of B / A rows in turn, and each one's
    graph is differentiated before the next is built; a batch A does not
    divide raises."""
    p, x, y = _problem(2)
    seen = []

    def loss(params, xb, yb):
        seen.append((xb.shape[0], torch.is_grad_enabled()))
        return _torch_loss(params, xb, yb)

    ocfg = opt_lib.OptimizerConfig(lr=1e-2, accum_steps=4,
                                   accum_dtype=torch.float64)
    params = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    real = torch.autograd.grad
    calls = []

    def grad(out, inputs, **kw):
        calls.append(len(seen))
        return real(out, inputs, **kw)

    torch.autograd.grad = grad
    try:
        state = ts.init_state(None, params, ocfg)
        _, m = ts.make_train_step(loss, ocfg)(state, _t(x), _t(y))
    finally:
        torch.autograd.grad = real
    assert seen == [(8, True)] * 4
    assert calls == [1, 2, 3, 4]         # grad after each microbatch
    assert m["grad_norm"].dtype == torch.float64
    with pytest.raises(ValueError, match="divide"):
        ts.make_train_step(loss, ocfg)(state, _t(x[:30]), _t(y[:30]))


def test_constant_schedule_matches_jax():
    for sched in ("cosine", "constant"):
        cfg = opt_lib.OptimizerConfig(lr=3e-3, warmup_steps=4,
                                      total_steps=50, schedule=sched)
        jcfg = jopt.OptimizerConfig(lr=3e-3, warmup_steps=4,
                                    total_steps=50, schedule=sched)
        for step in (0, 3, 10, 49):
            assert opt_lib.schedule_lr(cfg, step) == float(
                jopt.schedule_lr(jcfg, jnp.int32(step)))


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_atomicity_and_keep_n():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
        for s in (1, 2, 3, 4):
            ckpt.save(d, s, tree, keep_n=2)
        assert ckpt.latest_step(d) == 4
        assert len(os.listdir(d)) == 2
        # a partial (manifest-less) directory and a stale .tmp are ignored
        os.makedirs(os.path.join(d, "step_0000000099"))
        os.makedirs(os.path.join(d, "step_0000000100.tmp"))
        assert ckpt.latest_step(d) == 4
        restored, man = ckpt.restore_latest(d, tree)
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert man["step"] == 4 and man["keys"] == ["a", "b/c"]
        assert ckpt.restore_latest(os.path.join(d, "none"), tree) is None


def _tree_np():
    rng = np.random.RandomState(3)
    return {"index": {"R": rng.randn(4, 4).astype(np.float32),
                      "codebooks": rng.randn(2, 3, 2).astype(np.float32)},
            "item_table": rng.randn(5, 3).astype(np.float32),
            "counts": np.arange(6, dtype=np.int32),
            "pipe": {"seed": 5, "step": 17}}


def test_checkpoint_written_by_jax_restores_in_the_port():
    tree = _tree_np()
    like = {"index": {"R": torch.zeros(4, 4),
                      "codebooks": torch.zeros(2, 3, 2)},
            "item_table": torch.zeros(5, 3),
            "counts": torch.zeros(6, dtype=torch.int32),
            "pipe": {"seed": 0, "step": 0}}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 7, jax.tree.map(
            lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a,
            tree), metadata={"by": "jax"})
        got, man = ckpt.restore(d, 7, like)
    assert man["metadata"] == {"by": "jax"}
    for k in ("R", "codebooks"):
        assert torch.equal(got["index"][k], _t(tree["index"][k]))
    assert torch.equal(got["item_table"], _t(tree["item_table"]))
    assert got["counts"].dtype == torch.int32
    assert torch.equal(got["counts"], _t(tree["counts"]))
    assert got["pipe"] == {"seed": 5, "step": 17}


def test_checkpoint_written_by_the_port_restores_in_jax():
    """The port's flat path keys ("index/R") are the JAX package's keys of
    the nested tree; arrays bit-equal."""
    tree = _tree_np()
    flat = {"index/R": _t(tree["index"]["R"]),
            "index/codebooks": _t(tree["index"]["codebooks"]),
            "item_table": _t(tree["item_table"]),
            "counts": _t(tree["counts"]), "pipe": tree["pipe"]}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_async(d, 3, flat)
        ckpt.wait_pending()
        with open(os.path.join(d, "step_0000000003", "manifest.json")) as f:
            keys = json.load(f)["keys"]
        got, _ = jckpt.restore(d, 3, tree)
    assert keys == sorted(["index/R", "index/codebooks", "item_table",
                           "counts", "pipe/seed", "pipe/step"])
    for k in ("R", "codebooks"):
        np.testing.assert_array_equal(got["index"][k], tree["index"][k])
    np.testing.assert_array_equal(got["item_table"], tree["item_table"])
    np.testing.assert_array_equal(got["counts"], tree["counts"])
    assert got["pipe"] == tree["pipe"]


def test_checkpoint_save_async_snapshots_and_restore_follows_like():
    """save_async copies the leaves before it returns (a later in-place
    update does not reach the file); restore follows ``like``'s dtype and
    device, a bfloat16 leaf round-trips exactly, a NamedTuple and a module
    keep their structure, and a shape mismatch raises."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    state = opt_lib.OptState(mu={"w": w.clone()}, nu={"w": w.clone()},
                             rot={}, step=4)
    module = torch.nn.Linear(3, 2)
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save_async(d, 1, {"w": w, "bf": bf, "opt": state,
                                   "m": module})
        w.add_(100.0)
        t.join()
        ckpt.wait_pending()
        like = {"w": torch.zeros(2, 3), "bf": torch.zeros(3,
                                                          dtype=torch.bfloat16),
                "opt": state, "m": module}
        got, _ = ckpt.restore(d, 1, like)
        assert torch.equal(got["w"], w - 100.0)
        assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"],
                                                                 bf)
        assert isinstance(got["opt"], opt_lib.OptState)
        assert got["opt"].step == 4
        assert set(got["m"]) == {"weight", "bias"}
        assert torch.equal(got["m"]["weight"], module.weight.detach())
        with pytest.raises(ValueError, match="mismatch"):
            ckpt.restore(d, 1, dict(like, w=torch.zeros(3, 2)))


# -- the input pipeline -------------------------------------------------------


def _make(g: torch.Generator):
    return torch.randn((4, 8), generator=g), torch.randint(
        0, 10, (4,), generator=g)


def test_pipeline_prefetch_bit_identical_and_resume():
    """Prefetch on equals off bit for bit, and state()/restore() mid-stream
    (with a batch in flight) reproduces the uninterrupted stream (the
    counterpart of ``tests/test_training.py``'s pipeline test)."""
    sync = pipe_lib.Pipeline(_make, seed=5, prefetch=False, device="cpu")
    want = [next(sync) for _ in range(8)]
    pre = pipe_lib.Pipeline(_make, seed=5, prefetch=True, device="cpu")
    got = [next(pre) for _ in range(8)]
    for w, g in zip(want, got):
        assert torch.equal(w[0], g[0]) and torch.equal(w[1], g[1])
    assert pre.prefetch_hits >= 6 and pre.prefetch_misses == 1
    pre.close()
    pre.close()                           # idempotent
    sync.close()
    for prefetch in (False, True):
        p1 = pipe_lib.Pipeline(_make, seed=5, prefetch=prefetch,
                               device="cpu")
        for _ in range(3):
            next(p1)
        cursor = p1.state()
        assert cursor == {"seed": 5, "step": 3}
        p1.close()
        p2 = pipe_lib.Pipeline(_make, seed=0, prefetch=prefetch,
                               device="cpu")
        p2.restore(cursor)
        rest = [next(p2) for _ in range(5)]
        for w, g in zip(want[3:], rest):
            assert torch.equal(w[0], g[0]) and torch.equal(w[1], g[1])
        p2.close()


def test_pipeline_counters_and_generator_rule():
    reg = obs.Registry()
    p = pipe_lib.Pipeline(_make, seed=2, prefetch=True, registry=reg,
                          device="cpu")
    g = p.peek_generator()
    first = next(p)
    assert torch.equal(first[0], _make(g)[0])
    for _ in range(4):
        next(p)
    p.restore({"seed": 2, "step": 1})
    next(p)                               # a miss: the slot was dropped
    assert reg.counter("pipeline.prefetch_hits").value == p.prefetch_hits
    assert reg.counter("pipeline.prefetch_misses").value == 2
    p.close()
    assert pipe_lib.step_seed(0, 1) != pipe_lib.step_seed(1, 0)
    assert pipe_lib.step_seed(3, 4) == (3 << 32) + 4
    assert not pipe_lib.Pipeline(_make, device="cpu").prefetch


def test_pipeline_package_reexports():
    assert pipeline.Pipeline is pipe_lib.Pipeline
    assert pipeline.BackgroundCompactor is churn.BackgroundCompactor
    assert pipeline.StalenessTracker is churn.StalenessTracker
    assert set(pipeline.__all__) == {"Pipeline", "LiveIndexLoop",
                                     "BackgroundCompactor",
                                     "StalenessTracker"}


# -- LiveIndexLoop ------------------------------------------------------------


def _index_arrays(index) -> dict:
    return dict(R=np.asarray(index.R), centroids=np.asarray(index.centroids),
                codebooks=np.asarray(index.codebooks),
                codes=np.asarray(index.codes), ids=np.asarray(index.ids),
                list_offsets=np.asarray(index.list_offsets),
                block_size=index.block_size)


@pytest.fixture(scope="module")
def live():
    """(JAX index, port index, queries, six JAX GCD-G deltas of R and
    their port twins)."""
    X = jsynth.sift_like(jax.random.PRNGKey(0), N, DIM)
    R = jgivens.random_rotation(jax.random.PRNGKey(1), DIM)
    cfg = jivf.IVFPQConfig(num_lists=L, pq=jquant.PQConfig(D, K),
                           block_size=BS)
    jindex = jivf.build(jax.random.PRNGKey(2), X, R, cfg, coarse_iters=4,
                        pq_iters=4)
    tindex = convert.index_from_numpy(_index_arrays(jindex), device="cpu")
    Q = np.asarray(jsynth.sift_like(jax.random.PRNGKey(3), 16, DIM))
    learner = jrot.make("gcd_greedy")
    st = learner.init_from(jindex.R)
    jd, td = [], []
    for s in range(6):
        G = jax.random.normal(jax.random.PRNGKey(10 + s), (DIM, DIM))
        st, d = learner.update(st, G, 2e-3, jax.random.PRNGKey(s))
        jd.append(d)
        td.append(rotations.GivensDelta(pi=_t(d.pi), pj=_t(d.pj),
                                        theta=_t(d.theta)))
    return jindex, tindex, Q, jd, td


def test_live_index_loop_matches_jax(live):
    """The JAX Engine and the port's, from one index, driven by the same
    deltas through each package's LiveIndexLoop (refresh every 2 steps):
    after each round the results, stats() and the tracker's epoch
    agree."""
    jindex, tindex, Q, jd, td = live
    jeng = jsearch.Engine(jsearch.make("ivf"),
                          jsearch.IVF.attach(jindex, nprobe=4), k=10,
                          nprobe=4, min_bucket=16)
    teng = search.Engine(search.make("ivf"),
                         search.IVF.attach(tindex, nprobe=4), k=10,
                         nprobe=4, min_bucket=16)
    jtr = jchurn.StalenessTracker(np.arange(N))
    ttr = churn.StalenessTracker(np.arange(N))
    jloop = JLiveIndexLoop(jeng, refresh_every=2, tracker=jtr)
    tloop = pipeline.LiveIndexLoop(teng, refresh_every=2, tracker=ttr,
                                   registry=obs.Registry())
    for s in range(6):
        jloop.on_step({"rotation_deltas": {"R": jd[s]}})
        tloop.on_step({"rotation_deltas": {"R": td[s]}})
        if (s + 1) % 2:
            continue
        want = jeng.search(jnp.asarray(Q))
        got = teng.search(_t(Q))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=1e-4,
                                   rtol=1e-5)
        js, ts_ = jloop.stats(), tloop.stats()
        assert ts_ == js, (ts_, js)
        assert ttr.epoch == jtr.epoch == s + 1
        np.testing.assert_allclose(teng.state.index.R.numpy(),
                                   np.asarray(jeng.state.index.R),
                                   atol=1e-5, rtol=0)
    assert tloop.stats()["deltas_applied"] == 6
    assert tloop.stats()["refresh_rounds"] == 3


def test_live_index_loop_delta_key_and_buffering(live):
    _, tindex, _, _, td = live
    eng = search.Engine(search.make("ivf"), search.IVF.attach(tindex),
                        k=10, min_bucket=16)
    loop = pipeline.LiveIndexLoop(eng, delta_key="index/R", refresh_every=4,
                                  registry=obs.Registry())
    with pytest.raises(KeyError, match="delta_key"):
        loop.on_step({"rotation_deltas": {"R": td[0]}})
    loop.on_step({"loss": 1.0})           # a step without deltas
    loop.on_step({"rotation_deltas": {"index/R": td[0]}})
    assert loop.stats()["buffered"] == 1
    assert eng.stats()["refreshes"] == 0
    assert loop.flush_refresh() == 1
    assert loop.flush_refresh() == 0
    st = loop.stats()
    assert st["buffered"] == 0 and st["refreshes"] == 1
    assert st["staleness_epoch"] == 0 and st["tracked_rows"] == 0


def test_live_index_loop_drain_lands_a_background_pass(live):
    """compact_every = 1: each round submits a pass; drain() joins it and
    swaps it in, with the stalest rows re-encoded."""
    _, tindex, _, _, td = live
    X = _t(np.asarray(jsynth.sift_like(jax.random.PRNGKey(0), N, DIM)))
    eng = search.Engine(search.make("ivf"), search.IVF.attach(tindex),
                        k=10, min_bucket=16)
    tracker = churn.StalenessTracker(np.arange(N))
    comp = churn.BackgroundCompactor(
        eng, tracker=tracker, reencode_rows=64,
        reencode_fn=lambda ids: X[torch.as_tensor(np.asarray(ids))])
    loop = pipeline.LiveIndexLoop(eng, refresh_every=3, tracker=tracker,
                                  compactor=comp, compact_every=1)
    for s in range(3):
        loop.on_step({"rotation_deltas": {"R": td[s]}})
    assert comp.in_flight or comp.poll()
    loop.drain()
    ch = eng.stats()["churn"]
    assert ch["bg_compactions"] == 1
    assert ch["reencoded"] == 64
    assert not comp.in_flight
    assert loop.stats()["staleness_epoch"] == 3
    comp.close()


# -- the benchmark ------------------------------------------------------------

TINY = dict(n=3000, dim=16, queries=16, lists=8, subspaces=4, codewords=16,
            steps=12, batch=256, nprobe=4, refresh_every=3, compact_every=2,
            reencode_rows=64, staging_rows=64, churn_batch=16,
            churn_every=2, warmup=4, probe_every=3)


def test_train_e2e_bench_on_cpu():
    """The port of benchmarks/train_e2e.py at a tiny size: every check
    computed, the loop's counts as the cadence implies, and the bare arm
    deterministic across two runs."""
    results, checks = train_e2e.run(verbose=False, device="cpu", **TINY)
    assert set(checks) == {
        "live_step_overhead_ok", "bg_p99_below_sync",
        "zero_steady_recompiles", "recall_matches_rebuild",
        "background_ran", "prefetch_effective", "training_converged"}
    for name in ("zero_steady_recompiles", "background_ran",
                 "prefetch_effective", "training_converged"):
        assert checks[name], name
    assert results["loop"]["deltas_applied"] == TINY["steps"]
    assert results["loop"]["refresh_rounds"] == \
        TINY["steps"] // TINY["refresh_every"]
    assert len(results["recall_trajectory"]) == \
        TINY["steps"] // TINY["probe_every"]
    assert results["loss_live"] == results["loss_bare"]

    pool, Q, index0 = train_e2e.setup(
        TINY["n"], TINY["dim"], TINY["queries"], TINY["lists"],
        TINY["subspaces"], TINY["codewords"], TINY["nprobe"], TINY["steps"],
        TINY["churn_batch"], TINY["churn_every"], "cpu")
    live0 = np.zeros(pool.shape[0], dtype=bool)
    live0[:TINY["n"]] = True
    sched = train_e2e.schedule(TINY["n"], TINY["steps"],
                               TINY["churn_batch"], TINY["churn_every"])
    kw = {k: TINY[k] for k in ("steps", "batch", "dim", "nprobe",
                               "staging_rows", "refresh_every",
                               "compact_every", "reencode_rows", "warmup",
                               "probe_every")}
    runs = [train_e2e.train_arm("bare", index0=index0, pool=pool, Q=Q,
                                live0=live0, sched=sched, seed=7, **kw)
            for _ in range(2)]
    assert runs[0]["loss_final"] == runs[1]["loss_final"]
    assert torch.equal(runs[0]["R_final"], runs[1]["R_final"])
    assert threading.active_count() < 50


def test_train_e2e_schedule_is_balanced():
    sched = train_e2e.schedule(100, 8, 5, 2)
    live = np.zeros(100 + 5 * 5, dtype=bool)
    live[:100] = True
    for s, entry in enumerate(sched):
        if (s + 1) % 2:
            assert entry is None
            continue
        add_ids, dead = entry
        assert live[dead].all() and not live[add_ids].any()
        live[dead] = False
        live[add_ids] = True
        assert live.sum() == 100
