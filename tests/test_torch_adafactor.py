"""The port's Adafactor (``repro_torch.training.optimizer``,
``name="adafactor"``) and ``launch.cells._opt_cfg_for`` against the JAX
package on the CPU.

The factored state's shapes (2-D, a stacked (L, E, d, f) expert leaf,
1-D) and dtypes; three updates in float32 and in bf16 compute, with and
without weight decay and the global clip, a manifold leaf routed beside
them; the squares taken in the gradient's own dtype; a checkpoint written
by either package read by the other; the JAX package's convergence test;
three train steps of grok-1's smoke config against JAX; and the optimizer
each full config gets, counted from ``num_params`` with nothing allocated.

In bf16 the JAX reference is not one rounding: under ``jax.jit`` XLA on
the CPU drops the bf16 rounding of a 2-D leaf's square (its stats are
float32 squares, up to 2⁻⁹ relative from the port's, which rounds as the
JAX source says) but keeps it for a stacked leaf; the bf16 checks allow
for that (ROADMAP.md, parity hazards).
"""
from __future__ import annotations

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import rotations as jrot
from repro.core.kv_quant import KVQuantConfig as JKVQuantConfig
from repro.data import synthetic as jsynth
from repro.launch import cells as jcells
from repro.models import transformer as jtfm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_state as jts
from repro_torch import configs, convert, rotations
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.launch import cells
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

SHAPES = {"w": (8, 12), "experts": (2, 3, 8, 6), "b": (10,), "R": (8, 8)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's small shapes: the suite runs in
    several worker processes on one machine, and a thread a core in each
    slows small ops many times over (the grok-1 launcher test: 1.2 s
    alone, 145 s beside five other workers)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _cfgs(compute=torch.float32, **kw):
    """The same Adafactor config in both packages (the frozen learner on
    the manifold leaves unless ``rotation`` is given)."""
    rot = kw.pop("rotation", dict(learner="frozen"))
    base = dict(name="adafactor", lr=0.05, grad_clip=0.0, warmup_steps=0,
                schedule="constant")
    base.update(kw)
    jcfg = jopt.OptimizerConfig(compute_dtype=JDT[compute],
                                moment_dtype=jnp.bfloat16,
                                rotation=jrot.RotationConfig(**rot), **base)
    tcfg = opt_lib.OptimizerConfig(compute_dtype=compute,
                                   moment_dtype=torch.bfloat16,
                                   rotation=rotations.RotationConfig(**rot),
                                   **base)
    return jcfg, tcfg


def _problem(seed: int = 0):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    p["R"] = np.linalg.qr(rng.standard_normal((8, 8)))[0].astype(np.float32)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    return p, grads


@pytest.mark.parametrize("shape", [(8, 12), (2, 3, 8, 6), (10,), ()])
def test_factored_shapes_match_jax(shape):
    assert opt_lib.factored_shapes(shape) == jopt.factored_shapes(shape)


def test_adafactor_state_is_float32_and_factored_whatever_moment_dtype():
    """init puts the row stat in mu and the column stat in nu, float32
    even with bf16 moments, for every leaf (the manifold one too), the
    shapes of the JAX package's init."""
    p, _ = _problem()
    jcfg, tcfg = _cfgs()
    jstate = jopt.init({k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    state = opt_lib.init({k: _t(v) for k, v in p.items()}, tcfg)
    for k in SHAPES:
        for got, want in ((state.mu[k], jstate.mu[k]),
                          (state.nu[k], jstate.nu[k])):
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            assert tuple(got.shape) == want.shape, k
    assert tuple(state.mu["experts"].shape) == (2, 3, 8)
    assert tuple(state.nu["experts"].shape) == (2, 3, 6)
    assert state.rot["R"] is not None


@pytest.mark.parametrize("compute,wd,clip", [
    (torch.float32, 0.0, 0.0), (torch.float32, 0.1, 1.0),
    (torch.bfloat16, 0.0, 0.0), (torch.bfloat16, 0.1, 1.0)],
    ids=["f32", "f32_wd_clip", "bf16", "bf16_wd_clip"])
def test_adafactor_three_updates_match_jax(compute, wd, clip):
    """Three updates of float32 parameters (a 2-D, a stacked 4-D, a 1-D
    and a manifold leaf) against the jitted JAX update: float32 compute
    within 1e-6 of each leaf's largest entry, the stats within 1e-6
    relative; bf16 compute (every parameter rounded to bf16 each step)
    within two bf16 ulps (2⁻⁶ relative), and the stats within 2⁻⁶: XLA
    drops bf16 roundings the port keeps (the 2-D leaf's square, and the
    clipped bf16 gradient before the 1-D leaf's float32 square: one ulp of
    g, two of g²; the module docstring). The manifold leaf goes to its
    learner and its stat slots pass through as zeros."""
    p, grads = _problem()
    jcfg, tcfg = _cfgs(compute, weight_decay=wd, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = jopt.init(jp, jcfg)
    tp = {k: _t(v) for k, v in p.items()}
    state = opt_lib.init(tp, tcfg)
    for i, g in enumerate(grads):
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp, jcfg, jax.random.PRNGKey(i))
        tp, state = opt_lib.update({k: _t(v) for k, v in g.items()}, state,
                                   tp, tcfg)
    assert state.step == 3
    f32 = compute == torch.float32
    for k in SHAPES:
        got, want = tp[k].numpy(), np.asarray(jp[k])
        assert tp[k].dtype == torch.float32
        if f32:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=1e-6,
                                       err_msg=k)
        for s, js in ((state.mu[k], jstate.mu[k]),
                      (state.nu[k], jstate.nu[k])):
            np.testing.assert_allclose(
                s.numpy(), np.asarray(js), rtol=1e-6 if f32 else 2.0 ** -6,
                atol=1e-30, err_msg=k)
    np.testing.assert_array_equal(tp["R"].numpy(), p["R"])
    assert not state.mu["R"].any() and not state.nu["R"].any()
    assert np.abs(tp["w"].numpy() - p["w"]).max() > 0.05


def test_adafactor_squares_in_the_gradient_dtype():
    """One step from zero state (t = 1: the decay 1 − t^−0.8 is 0, so the
    stats are this gradient's): a bf16 gradient's squares are rounded to
    bf16 before the float32 sum, as the JAX source's
    ``_f32_mean_sq_over`` computes them (run eagerly), and not squared in
    float32 (which differs by more than 1e-4 here)."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 16, 24)).astype(np.float32)
    gb = jnp.asarray(g, jnp.bfloat16)
    _, tcfg = _cfgs(torch.bfloat16)
    p = {"e": torch.zeros((2, 16, 24), dtype=torch.bfloat16)}
    state = opt_lib.init(p, tcfg)
    opt_lib.update({"e": _t(np.asarray(gb, np.float32)).to(torch.bfloat16)},
                   state, p, tcfg)
    for stat, axis in ((state.mu["e"], -1), (state.nu["e"], -2)):
        want = np.asarray(jopt._f32_mean_sq_over(gb, axis))
        np.testing.assert_allclose(stat.numpy(), want, rtol=1e-6)
        f32sq = (np.asarray(gb, np.float64) ** 2).mean(axis)
        assert np.abs(stat.numpy() / f32sq - 1).max() > 1e-4


def test_adafactor_checkpoints_read_across_packages():
    """An Adafactor state with bf16 moment_dtype after one update, written
    by the JAX package and read by the port (float32 stats), and written by
    the port and read by the JAX package, every stat equal; convert reads
    the JAX arrays into float32 stats."""
    p, grads = _problem()
    jcfg, tcfg = _cfgs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads[0].items()},
                            jopt.init(jp, jcfg), jp, jcfg,
                            jax.random.PRNGKey(0))
    tp = {k: _t(v) for k, v in p.items()}
    like = opt_lib.init(tp, tcfg)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 1, {"opt": jstate})
        got, _ = ckpt.restore(d, 1, {"opt": like})
    got = got["opt"]
    assert got.step == 1
    for k in SHAPES:
        for s, js in ((got.mu[k], jstate.mu[k]), (got.nu[k], jstate.nu[k])):
            assert s.dtype == torch.float32
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _, tstate = opt_lib.update({k: _t(v) for k, v in grads[0].items()},
                               opt_lib.init(tp, tcfg), tp, tcfg)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"opt": tstate})
        back, _ = jckpt.restore(d, 1, {"opt": jopt.init(jp, jcfg)})
    for k in SHAPES:
        np.testing.assert_array_equal(np.asarray(back["opt"].mu[k]),
                                      tstate.mu[k].numpy())
        np.testing.assert_array_equal(np.asarray(back["opt"].nu[k]),
                                      tstate.nu[k].numpy())
    conv = convert.opt_state_from_numpy(
        {"mu": {k: np.asarray(v) for k, v in jstate.mu.items()},
         "nu": {k: np.asarray(v) for k, v in jstate.nu.items()},
         "step": jstate.step,
         "rot": {k: dict(v._asdict()) for k, v in jstate.rot.items()}},
        tcfg, device="cpu")
    for k in SHAPES:
        assert conv.mu[k].dtype == conv.nu[k].dtype == torch.float32
        np.testing.assert_array_equal(conv.nu[k].numpy(),
                                      np.asarray(jstate.nu[k]))


def test_adafactor_state_is_factored_and_converges():
    """The JAX package's tests/test_training.py test on the port: (8, 16)
    keeps an (8,) and a (16,) stat and 60 steps at lr 0.3 pull w to its
    target."""
    cfg = opt_lib.OptimizerConfig(name="adafactor", lr=0.3, grad_clip=0.0,
                                  warmup_steps=0, schedule="constant")
    w = torch.randn((8, 16), generator=torch.Generator().manual_seed(0))
    params = {"w": w}
    state = opt_lib.init(params, cfg)
    assert tuple(state.mu["w"].shape) == (8,)
    assert tuple(state.nu["w"].shape) == (16,)
    target = torch.ones((8, 16))
    for _ in range(60):
        params, state = opt_lib.update({"w": 2 * (params["w"] - target)},
                                       state, params, cfg)
    assert float((params["w"] - target).abs().mean()) < 0.15


def test_three_adafactor_train_steps_of_grok_smoke_match_jax():
    """Three make_train_step steps of grok-1's smoke config (MoE, the KV
    term, GCD-G on the stacked kvq rotations) with an explicit Adafactor
    config on the JAX package's batch stream: each step's loss (1e-5) and
    every parameter after (1e-4 of its largest entry); the expert leaves
    moved. The gradient norm is held to 1e-3 only: the jitted JAX step's
    ``global_norm`` here is 2.3e-4 from the float64 norm of its own
    gradients (its standalone call 7e-6; the port's 3e-8). With
    ``grad_clip`` 0 the norm is a metric and moves nothing."""
    jcfg = jconfigs.get("grok-1-314b").make_smoke()
    cfg = configs.get("grok-1-314b").make_smoke()
    hd = cfg.head_dim
    jcfg = jcfg._replace(kv_quant=JKVQuantConfig(hd, 4, 16),
                         train_kv_quant=True)
    cfg = cfg._replace(kv_quant=KVQuantConfig(hd, 4, 16), train_kv_quant=True)
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    p = convert.transformer_params_from_numpy(jax.tree.map(np.asarray, jp),
                                              cfg, device="cpu")
    for leaf in opt_lib.named_leaves(p).values():
        leaf.requires_grad_(True)
    jocfg, tocfg = _cfgs(
        lr=1e-2, warmup_steps=1, total_steps=10, schedule="cosine",
        rotation=dict(learner="gcd", method="greedy", lr=1e-2))
    jstep = jax.jit(jts.make_train_step(
        lambda pp, a, b: jtfm.forward_train(pp, a, b, jcfg), jocfg))
    tstep = ts.make_train_step(
        lambda pp, a, b: tfm.forward_train(pp, a, b, cfg), tocfg)
    jstate = jts.init_state(jax.random.PRNGKey(0), jp, jocfg)
    tstate = ts.init_state(None, p, tocfg)
    wi0 = p["layers"]["ffn"]["wi"].detach().clone()
    for i in range(3):
        tok, lab = jsynth.lm_batch(jax.random.PRNGKey(10 + i), 2, 16,
                                   cfg.vocab_size)
        jstate, jm = jstep(jstate, tok, lab)
        tstate, tm = tstep(tstate, _t(tok), _t(lab))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"])), i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-3 * float(jm["grad_norm"]), i
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    for k, v in opt_lib.named_leaves(tstate.params).items():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert float((tstate.params["layers"]["ffn"]["wi"] - wi0).abs().max()) > 0


@pytest.mark.parametrize("arch,name", [
    ("grok-1-314b", "adafactor"), ("llama4-maverick-400b-a17b", "adafactor"),
    ("nemotron-4-340b", "adafactor"), ("olmo-1b", "adamw")])
def test_opt_cfg_for_matches_jax_on_the_full_configs(arch, name):
    """``_opt_cfg_for`` on each full config (and its train_4k shape, whose
    accumulation it takes), counted from num_params with nothing
    allocated: Adafactor with no clip and bf16 dtypes over 50B
    parameters, AdamW in float32 with a clip of 1 below, every field the
    JAX package's."""
    for shape in (None, "train_4k"):
        spec, jspec = configs.get(arch), jconfigs.get(arch)
        cfg = spec.make_config() if shape is None else \
            spec.config_for_shape(shape)
        jcfg = jspec.make_config() if shape is None else \
            jspec.config_for_shape(shape)
        got, want = cells._opt_cfg_for(cfg), jcells._opt_cfg_for(jcfg)
        assert got.name == want.name == name
        for field in opt_lib.OptimizerConfig._fields:
            a, b = getattr(got, field), getattr(want, field)
            if field.endswith("_dtype"):
                assert str(a).split(".")[-1] == jnp.dtype(b).name, field
            elif field == "rotation":
                assert tuple(a)[:3] == tuple(b)[:3]
            else:
                assert a == b, field
        assert got.accum_steps == cfg.train_accum_steps
