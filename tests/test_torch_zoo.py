"""The port's recommender zoo (``repro_torch.models.recsys`` Wide&Deep,
MIND and DIN, ``data.synthetic.ctr_batch``/``din_batch``, the zoo's
configs and the launcher's resume) against the JAX package on the CPU, at
the ``make_smoke`` widths.

The JAX parameters are carried across with ``convert.*_params_from_numpy``
and the same numpy batches go through both packages. Tolerances: logits,
interests, scores and losses within 1e-5 of the largest entry (float32
sums in another order); every leaf's gradient within 1e-5 of the model's
largest gradient entry. A leaf's own largest entry is no scale here: DIN's
last attention bias has a zero gradient in exact arithmetic (the softmax
is shift-invariant), so both packages give rounding noise of 1e-12, and
MIND's last interest bias has a gradient of 1e-7 (the in-batch softmax
cancels it) against the model's 1.6e-3, which float32 gets to 0.4%. The
batch makers draw from a torch generator, which cannot reproduce JAX's
threefry, so they are held by property: shapes, dtypes, ranges and label
rates.
"""
from __future__ import annotations

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import synthetic as jsynth
from repro.models import recsys as jrecsys
from repro.training import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.configs import base
from repro_torch.data import synthetic
from repro_torch.launch import train as launch
from repro_torch.models import recsys
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib

ZOO = ["graphsage-reddit", "wide-deep", "mind", "din"]
B = 16
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one machine."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rel: float = REL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jopt.path_key(p): np.asarray(v) for p, v in leaves}


def _grads_close(model, loss, jgrads) -> None:
    """Every leaf's gradient within 1e-5 of the model's largest gradient
    entry (module docstring)."""
    named = opt_lib.named_leaves(model)
    grads = torch.autograd.grad(loss, list(named.values()))
    want = _flat(jgrads)
    assert set(named) == set(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for (k, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=REL * scale,
                                   rtol=0, err_msg=k)


def _pair(arch_id: str, init, convert_fn):
    jcfg = jconfigs.get(arch_id).make_smoke()
    tcfg = configs.get(arch_id).make_smoke()
    jp = init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert_fn(_flat(jp), tcfg, device="cpu")


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ZOO)
def test_zoo_configs_match_jax(arch_id):
    """The registry knows the four; full and smoke configs carry the JAX
    package's fields (dtypes aside), and so do GraphSAGE's adjusted ones."""
    spec, jspec = configs.get(arch_id), jconfigs.get(arch_id)
    assert spec.family == jspec.family and set(spec.shapes) == set(
        jspec.shapes)
    for make in ("make_config", "make_smoke"):
        a, b = getattr(spec, make)(), getattr(jspec, make)()
        for f in a._fields:
            if f not in ("dtype", "param_dtype"):
                assert getattr(a, f) == getattr(b, f), (make, f)
    if arch_id == "graphsage-reddit":
        for shape in base.GNN_SHAPES:
            a, b = spec.config_for_shape(shape), jspec.config_for_shape(shape)
            assert (a.d_in, a.sample_sizes) == (b.d_in, b.sample_sizes)


def test_gnn_shapes_match_jax():
    assert base.GNN_SHAPES == jbase.GNN_SHAPES
    assert set(configs.REGISTRY) == set(jconfigs.REGISTRY)


# -- Wide&Deep ----------------------------------------------------------------


def test_widedeep_forward_loss_and_grads_match_jax():
    jcfg, tcfg, jp, model = _pair("wide-deep", jrecsys.widedeep_init,
                                  convert.widedeep_params_from_numpy)
    assert set(opt_lib.named_leaves(model)) == set(_flat(jp))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, tcfg.vocab_per_field, (B, tcfg.n_sparse)).astype(
        np.int32)
    y = (rng.rand(B) < 0.4).astype(np.float32)
    _close(recsys.widedeep_forward(model, _t(ids), tcfg),
           jrecsys.widedeep_forward(jp, ids, jcfg))
    want, jg = jax.value_and_grad(
        lambda p: jrecsys.widedeep_loss(p, ids, y, jcfg))(jp)
    loss = recsys.widedeep_loss(model, _t(ids), _t(y), tcfg)
    _close(loss, want)
    _grads_close(model, loss, jg)


def test_psum_lookup_without_a_mesh_raises():
    """``psum_lookup=True`` takes its mesh explicitly; without one the
    model, the forward and ``convert`` name the missing mesh
    (``tests/test_torch_sharded_train.py`` holds the lookup itself)."""
    cfg = configs.get("wide-deep").make_smoke()._replace(psum_lookup=True)
    with pytest.raises(ValueError, match="mesh"):
        recsys.WideDeep.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    model = recsys.WideDeep.init(torch.Generator().manual_seed(0),
                                 cfg._replace(psum_lookup=False),
                                 device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        recsys.widedeep_forward(model, torch.zeros((2, cfg.n_sparse),
                                                   dtype=torch.long), cfg)
    with pytest.raises(ValueError, match="mesh"):
        convert.widedeep_params_from_numpy(
            {k: np.zeros(s.shape, np.float32)
             for k, s in recsys.widedeep_specs(cfg).items()}, cfg,
            device="cpu")


# -- MIND ---------------------------------------------------------------------


def _mind():
    return _pair("mind", jrecsys.mind_init, convert.mind_params_from_numpy)


def test_mind_interests_loss_and_grads_match_jax():
    """Interests (routing logits from 0: the interests tie, and the max's
    gradient is shared among them in both packages), loss and gradients,
    on histories with −1 padding."""
    jcfg, tcfg, jp, model = _mind()
    rng = np.random.RandomState(2)
    hist = rng.randint(0, tcfg.item_vocab, (B, tcfg.hist_len)).astype(
        np.int32)
    hist[:, 5:] = np.where(rng.rand(B, tcfg.hist_len - 5) < 0.5, -1,
                           hist[:, 5:])
    pos = rng.randint(0, tcfg.item_vocab, B).astype(np.int32)
    _close(recsys.mind_interests(model, _t(hist), tcfg),
           jrecsys.mind_interests(jp, hist, jcfg))
    want, jg = jax.value_and_grad(
        lambda p: jrecsys.mind_loss(p, hist, pos, jcfg))(jp)
    loss = recsys.mind_loss(model, _t(hist), _t(pos), tcfg)
    _close(loss, want)
    _grads_close(model, loss, jg)


def test_mind_retrieve_matches_jax():
    jcfg, tcfg, jp, model = _mind()
    rng = np.random.RandomState(3)
    hist = rng.randint(-1, tcfg.item_vocab, (3, tcfg.hist_len)).astype(
        np.int32)
    cand = rng.randn(300, tcfg.embed_dim).astype(np.float32)
    got = recsys.mind_retrieve(model, _t(hist), _t(cand), tcfg)
    assert got.shape == (3, 300)
    _close(got, jrecsys.mind_retrieve(jp, hist, cand, jcfg))


# -- DIN ----------------------------------------------------------------------


def _din():
    return _pair("din", jrecsys.din_init, convert.din_params_from_numpy)


def test_din_forward_loss_and_grads_match_jax():
    jcfg, tcfg, jp, model = _din()
    rng = np.random.RandomState(4)
    hist = rng.randint(-1, tcfg.item_vocab, (B, tcfg.hist_len)).astype(
        np.int32)
    tgt = rng.randint(0, tcfg.item_vocab, B).astype(np.int32)
    y = (rng.rand(B) < 0.5).astype(np.float32)
    _close(recsys.din_forward(model, _t(hist), _t(tgt), tcfg),
           jrecsys.din_forward(jp, hist, tgt, jcfg))
    want, jg = jax.value_and_grad(
        lambda p: jrecsys.din_loss(p, hist, tgt, y, jcfg))(jp)
    loss = recsys.din_loss(model, _t(hist), _t(tgt), _t(y), tcfg)
    _close(loss, want)
    _grads_close(model, loss, jg)


def test_din_all_padding_history_pools_zeros():
    """A history with no valid item: the −1e30 mask gives uniform weights
    over zeros, a finite logit equal to the JAX package's (not NaN), and
    finite gradients."""
    jcfg, tcfg, jp, model = _din()
    hist = -np.ones((2, tcfg.hist_len), np.int32)
    hist[1, :3] = [5, 6, 7]
    tgt = np.array([9, 10], np.int32)
    want = jrecsys.din_forward(jp, hist, tgt, jcfg)
    got = recsys.din_forward(model, _t(hist), _t(tgt), tcfg)
    assert bool(torch.all(torch.isfinite(got)))
    _close(got, want)
    empty = jrecsys.din_forward(jp, hist[:1], tgt[:1], jcfg)
    assert np.isfinite(np.asarray(empty)).all()
    loss = recsys.din_loss(model, _t(hist), _t(tgt), torch.ones(2), tcfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


def test_din_score_candidates_matches_jax():
    """One user against 2,000 candidates in chunks of 512: the last
    partial chunk is not scored, as in the JAX package."""
    jcfg, tcfg, jp, model = _din()
    rng = np.random.RandomState(5)
    hist = rng.randint(-1, tcfg.item_vocab, tcfg.hist_len).astype(np.int32)
    cand = rng.randint(0, tcfg.item_vocab, 2000).astype(np.int32)
    want = jrecsys.din_score_candidates(jp, jnp.asarray(hist),
                                        jnp.asarray(cand), jcfg, chunk=512)
    got = recsys.din_score_candidates(model, _t(hist), _t(cand), tcfg,
                                      chunk=512)
    assert got.shape == (1536,)
    _close(got, want)


# -- the batch makers ---------------------------------------------------------


@pytest.mark.parametrize("n", [100, 16, 7, 1])
def test_median_is_jnp_median(n):
    """jnp.median averages the two middle values at an even count;
    torch.median returns the lower one."""
    x = np.random.RandomState(n).randint(0, 1000, (64, n)) % 97
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1))
    got = synthetic.median(_t(x), dim=1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if n % 2 == 0:
        assert not torch.equal(got, torch.median(_t(x), dim=1).values.float())


def test_ctr_batch_properties():
    g = torch.Generator().manual_seed(0)
    ids, labels = synthetic.ctr_batch(g, 20000, 6, 128)
    jids, jlab = jsynth.ctr_batch(jax.random.PRNGKey(0), 20000, 6, 128)
    assert ids.shape == tuple(jids.shape) and ids.dtype == torch.int64
    assert labels.shape == tuple(jlab.shape) and labels.dtype == torch.float32
    assert int(ids.min()) >= 0 and int(ids.max()) == 127
    assert set(torch.unique(labels).tolist()) == {0.0, 1.0}
    assert 0.3 < float(labels.mean()) < 0.7
    again = synthetic.ctr_batch(torch.Generator().manual_seed(0), 20000, 6,
                                128)
    assert torch.equal(ids, again[0]) and torch.equal(labels, again[1])


def test_din_batch_properties_and_label_rate():
    """Shapes, dtypes and ranges as the JAX batch's; the label rate equals
    the mean of sigmoid(1 − 0.1 |median(hist mod 97) − target mod 97|)
    computed from the batch's own ids, as JAX's does from its ids."""
    n, L, V = 20000, 100, 1000
    hist, tgt, lab = synthetic.din_batch(torch.Generator().manual_seed(1), n,
                                         L, V)
    jh, jt, jl = jsynth.din_batch(jax.random.PRNGKey(1), n, L, V)
    assert hist.shape == tuple(jh.shape) and tgt.shape == tuple(jt.shape)
    assert hist.dtype == tgt.dtype == torch.int64
    assert lab.dtype == torch.float32 and lab.shape == tuple(jl.shape)
    assert int(hist.min()) >= 0 and int(hist.max()) < V
    assert int(tgt.min()) >= 0 and int(tgt.max()) < V

    def rate(h, t):
        m = np.median(h % 97, axis=1) - t % 97
        return float(np.mean(1 / (1 + np.exp(-(1 - 0.1 * np.abs(m))))))

    p = rate(hist.numpy(), tgt.numpy())
    assert abs(float(lab.mean()) - p) < 0.015
    assert abs(float(np.mean(np.asarray(jl))) - rate(np.asarray(jh),
                                                     np.asarray(jt))) < 0.015
    assert abs(p - rate(np.asarray(jh), np.asarray(jt))) < 0.015


# -- the launcher -------------------------------------------------------------


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_launcher_resume_exact(arch, deterministic):
    """The JAX launcher's contract (tests/test_training.py) for each zoo
    family: six steps straight against the same job crashed after three
    and resumed from its checkpoint end at the same loss (rtol 1e-4), the
    parameters bit-equal."""
    kw = dict(steps=6, batch=16, seed=3, log_every=100, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        state_a, hist_a = launch.train(arch, ckpt_dir=None, **kw)
        _, hist_c = launch.train(arch, ckpt_dir=d, ckpt_every=100,
                                 stop_after=3, **kw)
        assert len(hist_c) == 3 and ckpt.latest_step(d) == 3
        state_b, hist_b = launch.train(arch, ckpt_dir=d, ckpt_every=100,
                                       **kw)
        assert len(hist_b) == 3 and ckpt.latest_step(d) == 6
    assert np.isclose(hist_a[-1], hist_b[-1], rtol=1e-4), (hist_a, hist_b)
    a, b = (opt_lib.named_leaves(s.params) for s in (state_a, state_b))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_convert_checks_keys_and_shapes():
    cfg = configs.get("din").make_smoke()
    arrays = {k: np.zeros(s.shape, np.float32)
              for k, s in recsys.din_specs(cfg).items()}
    model = convert.din_params_from_numpy(arrays, cfg, device="cpu")
    assert set(opt_lib.named_leaves(model)) == set(arrays)
    del arrays["head0_b"]
    with pytest.raises(KeyError):
        convert.din_params_from_numpy(arrays, cfg, device="cpu")
    arrays["head0_b"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError):
        convert.din_params_from_numpy(arrays, cfg, device="cpu")
