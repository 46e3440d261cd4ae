"""The port's training slice (``repro_torch.core.index_layer``,
``models``, ``training``, ``quant.opq``, ``data.synthetic.ClickLog``)
against the JAX package on the CPU, at the ``make_smoke`` width of the
paper's two-tower model (vocab 4096, embed 64, D = 8, K = 32) and batch 32.

The JAX model is initialised by the JAX package and its leaves carried
across with ``convert``; the batches come from a JAX ``ClickLog`` and the
port's log reuses its item vectors. Tolerances: the index layer's output,
distortion and gradients to 1e-5 relative; the loss to 1e-5 and its
gradients to 1e-4 relative (float32 sums over the in-batch score matrix in
another order); optimizer steps to 1e-5; three train steps' losses to
1e-4; the Procrustes solve to 1e-5. "Relative" for a tensor is to its
largest entry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rotations as jrot
from repro.configs import paper_twotower as jpaper
from repro.core import index_layer as jil
from repro.data import synthetic as jsynth
from repro.models import recsys as jrecsys
from repro.rotations import procrustes as jproc
from repro.training import optimizer as jopt
from repro.training import train_state as jts
from repro_torch import convert, quant, rotations
from repro_torch.configs import paper_twotower
from repro_torch.core import index_layer as il
from repro_torch.data import synthetic
from repro_torch.models import recsys
from repro_torch.quant import opq
from repro_torch.rotations.procrustes import procrustes_rotation
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

BATCH = 32
JCFG = jpaper.make_smoke()
TCFG = paper_twotower.make_smoke()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rel: float) -> None:
    """|got − want| ≤ rel · max|want| elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _flat(tree) -> dict:
    """A JAX parameter tree as {path key: numpy array}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jopt.path_key(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def setup():
    """JAX params (index warm-started by OPQ so codes are spread), the port
    model from the same leaves, a JAX ClickLog and the port's twin."""
    key = jax.random.PRNGKey(0)
    params = jrecsys.twotower_init(key, JCFG)
    v, _ = jrecsys.item_tower(params, jnp.arange(512), JCFG)
    params["index"] = jil.warm_start(jax.random.PRNGKey(1), v, JCFG.index,
                                     opq_iters=3)
    jlog = jsynth.ClickLog(0, JCFG.item_vocab, dim=32)
    tlog = synthetic.ClickLog(0, TCFG.item_vocab, dim=32,
                              item_vecs=jlog.item_vecs, device="cpu")
    return params, jlog, tlog


def _model(params):
    return convert.twotower_params_from_numpy(_flat(params), TCFG,
                                              device="cpu")


def test_convert_keeps_jax_leaf_names(setup):
    params, _, _ = setup
    model = _model(params)
    names = set(opt_lib.named_leaves(model))
    assert names == set(_flat(params))
    assert {"index/R", "index/codebooks", "item_table", "user1_w",
            "item0_b"} <= names
    bad = _flat(params)
    del bad["user0_w"]
    with pytest.raises(KeyError):
        convert.twotower_params_from_numpy(bad, TCFG, device="cpu")
    bad = _flat(params)
    bad["index/R"] = np.eye(3, dtype=np.float32)
    with pytest.raises(ValueError):
        convert.twotower_params_from_numpy(bad, TCFG, device="cpu")


def test_clicklog_batch_ids_match_jax(setup):
    _, jlog, tlog = setup
    for seed in (3, 1000):
        jh, jp = jlog.batch(seed, BATCH, JCFG.hist_len)
        th, tp = tlog.batch(seed, BATCH, TCFG.hist_len)
        assert th.dtype == torch.int32 and tp.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_clicklog_eval_queries_match_jax(setup):
    _, jlog, tlog = setup
    jh, jtruth = jlog.eval_queries(7, 16, JCFG.hist_len, k_truth=20)
    th, ttruth = tlog.eval_queries(7, 16, TCFG.hist_len, k_truth=20)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for a, b in zip(ttruth.numpy(), jtruth):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("m,n", [(300, 16), (64, 64)])
def test_procrustes_rotation_matches_jax(m, n):
    rng = np.random.RandomState(m + n)
    X = rng.randn(m, n).astype(np.float32)
    Y = rng.randn(m, n).astype(np.float32)
    want = np.asarray(jproc.procrustes_rotation(jnp.asarray(X),
                                                jnp.asarray(Y)))
    _close(procrustes_rotation(_t(X), _t(Y)), want, 1e-5)


def test_index_layer_apply_and_grads_match_jax(setup):
    """T(X), the distortion and the gradients wrt X, the codebooks and R."""
    params, _, _ = setup
    rng = np.random.RandomState(1)
    X = rng.randn(BATCH, JCFG.index.dim).astype(np.float32)
    W = rng.randn(BATCH, JCFG.index.dim).astype(np.float32)
    jp = params["index"]

    def jloss(x, p):
        out, dist = jil.apply(p, x)
        return jnp.sum(out * W) + dist, (out, dist)

    (_, (jout, jdist)), (jdx, jdp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(X), jp)
    layer = _model(params).index
    tx = _t(X).requires_grad_(True)
    out, dist = il.apply(layer, tx)
    np.testing.assert_array_equal(
        il.encode(layer, tx.detach()).numpy(),
        np.asarray(jil.encode(jp, jnp.asarray(X))))
    loss = torch.sum(out * _t(W)) + dist
    dx, dR, dcb = torch.autograd.grad(loss, (tx, layer.R, layer.codebooks))
    _close(out, jout, 1e-5)
    _close(dist, jdist, 1e-5)
    _close(dx, jdx, 1e-5)
    _close(dR, jdp.R, 1e-5)
    _close(dcb, jdp.codebooks, 1e-5)
    _close(il.apply_no_ste(layer, _t(X)),
           jil.apply_no_ste(jp, jnp.asarray(X)), 1e-5)


def test_adc_scores_and_retrieval_match_jax(setup):
    params, jlog, tlog = setup
    model = _model(params)
    ids = np.arange(JCFG.item_vocab)
    jv, _ = jrecsys.item_tower(params, jnp.asarray(ids), JCFG)
    jcodes = jil.encode(params["index"], jv)
    tv, _ = recsys.item_tower(model, _t(ids), TCFG)
    tcodes = il.encode(model.index, tv.detach())
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    hist, _ = jlog.batch(11, 8, JCFG.hist_len)
    want = jrecsys.twotower_retrieve_adc(params, hist, jcodes, JCFG)
    with torch.no_grad():
        got = recsys.twotower_retrieve_adc(model, _t(hist), tcodes, TCFG)
        dense = recsys.twotower_retrieve_dense(model, _t(hist), tv, TCFG)
    _close(got, want, 1e-5)
    _close(dense, jrecsys.twotower_retrieve_dense(params, hist, jv, JCFG),
           1e-5)


@pytest.mark.parametrize("use_index", [True, False])
def test_twotower_loss_and_grads_match_jax(setup, use_index):
    params, jlog, _ = setup
    h, pos = jlog.batch(5, BATCH, JCFG.hist_len)
    jloss, jgrads = jax.value_and_grad(jrecsys.twotower_loss)(
        params, h, pos, JCFG, use_index)
    model = _model(params)
    loss = recsys.twotower_loss(model, _t(h), _t(pos), TCFG, use_index)
    leaves = opt_lib.named_leaves(model)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    _close(loss, jloss, 1e-5)
    for (k, _), g in zip(leaves.items(), grads):
        want = _flat(jgrads)[k]
        if g is None:                   # the index layer when unused
            assert not use_index and k.startswith("index/")
            assert not np.any(want)
            continue
        _close(g, want, 1e-4)


def _ocfg(spec: str) -> jopt.OptimizerConfig:
    return dict(lr=3e-3, total_steps=50, warmup_steps=4, weight_decay=0.01,
                rotation=spec)


def test_optimizer_update_matches_jax(setup):
    """Two AdamW + GCD-G updates from JAX gradients fed in as numpy, so the
    greedy pairs are chosen from the same A; the second starts from the
    JAX state after the first, carried across by ``opt_state_from_numpy``."""
    params, jlog, _ = setup
    kw = _ocfg("gcd_greedy")
    jcfg = jopt.OptimizerConfig(**{**kw, "rotation": jrot.RotationConfig
                                   .from_spec("gcd_greedy", lr=3e-3)})
    tcfg = opt_lib.OptimizerConfig(**{**kw, "rotation": rotations
                                      .RotationConfig("gcd_greedy", lr=3e-3)})
    h, pos = jlog.batch(6, BATCH, JCFG.hist_len)
    grads = jax.grad(jrecsys.twotower_loss)(params, h, pos, JCFG, True)
    jstate = jopt.init(params, jcfg)
    key = jax.random.PRNGKey(2)
    p1, s1 = jopt.update(grads, jstate, params, jcfg, key)
    p2, _ = jopt.update(grads, s1, p1, jcfg, key)

    model = _model(params)
    state = opt_lib.init(model, tcfg)
    tg = {k: _t(v) for k, v in _flat(grads).items()}
    model, state = opt_lib.update(tg, state, model, tcfg)
    assert state.step == 1
    for k, v in opt_lib.named_leaves(model).items():
        _close(v, _flat(p1)[k], 1e-5)
    R0 = np.asarray(params["index"].R)
    assert np.abs(_flat(p1)["index/R"] - R0).max() > 0     # GCD moved R

    rot = {jopt.path_key(p): {"R": np.asarray(st.R),
                              "step": np.asarray(st.step),
                              "accum": np.asarray(st.accum),
                              "accum2": np.asarray(st.accum2)}
           for p, st in [((jax.tree_util.DictKey("index"),
                           jax.tree_util.GetAttrKey("R")),
                          s1.rot["index/R"])]}
    tstate = convert.opt_state_from_numpy(
        dict(mu=_flat(s1.mu), nu=_flat(s1.nu), step=s1.step, rot=rot), tcfg,
        device="cpu")
    model1 = convert.twotower_params_from_numpy(_flat(p1), TCFG,
                                                device="cpu")
    tg = {k: _t(v) for k, v in _flat(grads).items()}
    model1, tstate = opt_lib.update(tg, tstate, model1, tcfg)
    for k, v in opt_lib.named_leaves(model1).items():
        _close(v, _flat(p2)[k], 1e-5)


def test_schedule_and_global_norm_match_jax():
    cfg = jopt.OptimizerConfig(lr=3e-3, warmup_steps=4, total_steps=50)
    tcfg = opt_lib.OptimizerConfig(lr=3e-3, warmup_steps=4, total_steps=50)
    for step in (0, 3, 4, 17, 50, 60):
        assert opt_lib.schedule_lr(tcfg, step) == pytest.approx(
            float(jopt.schedule_lr(cfg, jnp.int32(step))), rel=1e-6)
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(opt_lib.global_norm({k: _t(v) for k, v in tree.items()}))
    assert got == pytest.approx(want, rel=1e-6)


def test_three_frozen_train_steps_match_jax(setup):
    """make_train_step with the frozen learner: the loss trajectory to 1e-4
    and R bit-equal to where it started."""
    params, jlog, _ = setup
    kw = _ocfg("frozen")
    jcfg = jopt.OptimizerConfig(**{**kw, "rotation": jrot.RotationConfig
                                   .from_spec("frozen")})
    tcfg = opt_lib.OptimizerConfig(**{**kw, "rotation": rotations
                                      .RotationConfig("frozen")})

    def jloss_fn(p, h, pos):
        return jrecsys.twotower_loss(p, h, pos, JCFG, use_index=True)

    def tloss_fn(p, h, pos):
        return recsys.twotower_loss(p, h, pos, TCFG, use_index=True)

    jstate = jts.init_state(jax.random.PRNGKey(3), params, jcfg)
    jstep = jax.jit(jts.make_train_step(jloss_fn, jcfg))
    model = _model(params)
    R0 = model.index.R.detach().clone()
    tstate = ts.init_state(None, model, tcfg)
    tstep = ts.make_train_step(tloss_fn, tcfg, emit_deltas=True)
    for i in range(3):
        h, pos = jlog.batch(2000 + i, BATCH, JCFG.hist_len)
        jstate, jm = jstep(jstate, h, pos)
        tstate, tm = tstep(tstate, _t(h), _t(pos))
        _close(tm["loss"], jm["loss"], 1e-4)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4)
        assert tm["rotation_deltas"]["index/R"].theta.numel() == 0
    assert torch.equal(model.index.R, R0)
    assert tstate.step == 3 and tstate.opt_state.step == 3


def test_train_step_skips_leaves_the_loss_does_not_reach(setup):
    """Warm-up without the index layer: the loss skips R and the codebooks,
    so the step hands the optimizer no gradient for them. They get a zero
    one, as under ``jax.grad``: with weight decay the codebooks shrink, GCD
    takes a zero-angle step, every leaf matches ``jopt.update`` from the
    JAX gradients (1e-5) and the index layer's moments equal JAX's."""
    params, jlog, _ = setup
    kw = _ocfg("gcd_greedy")
    jcfg = jopt.OptimizerConfig(**{**kw, "rotation": jrot.RotationConfig
                                   .from_spec("gcd_greedy", lr=3e-3)})
    tcfg = opt_lib.OptimizerConfig(**{**kw, "rotation": rotations
                                      .RotationConfig("gcd_greedy", lr=3e-3)})
    h, pos = jlog.batch(9, BATCH, JCFG.hist_len)
    grads = jax.grad(jrecsys.twotower_loss)(params, h, pos, JCFG, False)
    jstate = jopt.init(params, jcfg)
    p1, s1 = jopt.update(grads, jstate, params, jcfg, jax.random.PRNGKey(2))
    want = _flat(p1)

    model = _model(params)
    state = opt_lib.init(model, tcfg)
    tg = {k: _t(v) for k, v in _flat(grads).items()
          if not k.startswith("index/")}
    model, state = opt_lib.update(tg, state, model, tcfg)
    for k, v in opt_lib.named_leaves(model).items():
        _close(v, want[k], 1e-5)
    for moments, jmoments in ((state.mu, s1.mu), (state.nu, s1.nu)):
        for k in ("index/R", "index/codebooks"):
            np.testing.assert_array_equal(moments[k].numpy(),
                                          _flat(jmoments)[k])
    assert int(state.rot["index/R"].step) == 1

    model = _model(params)
    R0 = model.index.R.detach().clone()
    cb0 = model.index.codebooks.detach().clone()
    step = ts.make_train_step(lambda p, h, pos: recsys.twotower_loss(
        p, h, pos, TCFG, use_index=False), tcfg)
    state, _ = step(ts.init_state(None, model, tcfg), _t(h), _t(pos))
    assert torch.equal(model.index.R, R0)
    assert not torch.equal(model.index.codebooks, cb0)
    _close(model.index.codebooks, want["index/codebooks"], 1e-5)
    with pytest.raises(NotImplementedError):
        ts.make_train_step(lambda p: 0.0, tcfg._replace(accum_steps=2))


def test_eq1_loss_matches_jax():
    from repro import quant as jquant
    from repro.training.train_state import eq1_loss as jeq1

    rng = np.random.RandomState(4)
    X = rng.randn(20, 16).astype(np.float32)
    R = np.linalg.qr(rng.randn(16, 16))[0].astype(np.float32)
    C = rng.randn(4, 8, 4).astype(np.float32)

    def task(t):
        return (t ** 2).sum() * 0.5

    want = jeq1(jquant.PQ(jnp.asarray(C)), jnp.asarray(R), jnp.asarray(X),
                task)
    got = ts.eq1_loss(quant.PQ(_t(C)), _t(R), _t(X), task)
    _close(got, want, 1e-5)


def test_opq_procrustes_lowers_distortion_and_frozen_keeps_identity():
    """The port's OPQ loop (k-means init draws other numbers than JAX's, so
    by property): procrustes keeps R orthogonal and ends below the frozen
    control's distortion on anisotropic data."""
    g = torch.Generator().manual_seed(0)
    X = synthetic.sift_like(g, 2000, 16, device="cpu")
    cfg = quant.PQConfig(4, 8)
    R, pq, trace = opq.fit(torch.Generator().manual_seed(1), X, cfg,
                           iters=6)
    Rf, pqf, tracef = opq.fit(torch.Generator().manual_seed(1), X, cfg,
                              iters=6, rotation="frozen")
    assert float(rotations.orthogonality_error(R)) < 1e-5
    assert torch.equal(Rf, torch.eye(16))
    assert float(trace[-1]) < float(tracef[-1])
    layer = il.warm_start(torch.Generator().manual_seed(1), X,
                          il.IndexLayerConfig(16, 4, 8), opq_iters=6)
    torch.testing.assert_close(layer.R.detach(), R)
    with pytest.raises(NotImplementedError):
        opq.fit(g, X, cfg, rotation="cayley_sgd")


def test_registry_from_config_and_frozen():
    learner = rotations.from_config(rotations.RotationConfig("frozen"))
    assert isinstance(learner, rotations.Frozen)
    R = torch.eye(4)
    st, delta = learner.update(learner.init_from(R), torch.ones(4, 4), 0.1)
    assert st.R is R and int(st.step) == 1 and delta.theta.numel() == 0
    assert isinstance(rotations.from_config(rotations.RotationConfig()),
                      rotations.GCD)
    for spec in ("gcd_random", "gcd_overlap_greedy", "cayley_sgd"):
        with pytest.raises(NotImplementedError):
            rotations.from_config(rotations.RotationConfig(spec))
