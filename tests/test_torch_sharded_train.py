"""The port's sharded training half on CPU shards, held to the JAX package:
``embedding.sharded_lookup`` (the masked psum lookup), Wide&Deep with
``psum_lookup=True`` trained on a (data 1, model 4) mesh of CPU shards,
placed leaves through the optimizer (AdamW and Adafactor piece by piece,
``global_norm``), the pipeline's ``shardings`` and the mesh-agnostic
resume (4 → 2 → 1 shards).

The JAX references need several devices, so they come from one
module-scoped subprocess run with 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set only in the
child, as ``tests/test_distributed.py`` does); it reads its inputs from
and writes its results to npz files in a temporary directory.

Tolerances: the lookup's forward bit-equal (each id's row comes from one
shard, the others add exact zeros) and its gradient equal on dyadic
cotangents (every sum exact in any order); Wide&Deep's losses within 1e-6
relative of JAX's at every step and its parameters within 1e-6 (the
global norm sums in another order, and each package's float32 matmuls
round their own way); the placed Adafactor within 1e-6 of the whole
leaf's; the resumed runs' losses within 1e-6 relative of the straight
run's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data import pipeline as pipe_lib
from repro_torch.launch import cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import embedding, recsys
from repro_torch.sharding import placed as pl
from repro_torch.sharding import rules as sh
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, DIM, NIDS = 64, 8, (10, 6)
STEPS, BATCH, LR = 3, 64, 1e-2
TOL = 1e-6

CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro import configs
    from repro.launch import cells
    from repro.launch.mesh import make_mesh_compat
    from repro.models import embedding, recsys
    from repro.training import train_state as ts

    d = sys.argv[1]
    STEPS, LR = int(sys.argv[2]), float(sys.argv[3])
    inp = dict(np.load(os.path.join(d, "in.npz")))
    out = {}

    mesh = make_mesh_compat((2, 4), ("data", "model"))
    table, ids, w = (jnp.asarray(inp[k]) for k in ("table", "ids", "w"))
    fwd = jax.jit(lambda t, i: embedding.sharded_lookup(t, i, mesh, "model"))
    out["lookup"] = np.asarray(fwd(table, ids))
    out["lookup_plain"] = np.asarray(embedding.lookup(table, ids))
    grad = jax.jit(jax.grad(lambda t: jnp.sum(
        embedding.sharded_lookup(t, ids, mesh, "model") * w)))
    out["lookup_grad"] = np.asarray(grad(table))

    cfg = configs.get("wide-deep").make_smoke()._replace(psum_lookup=True)
    params = recsys.widedeep_init(jax.random.PRNGKey(0), cfg)
    for k, v in params.items():
        out["init/" + k] = np.asarray(v)
    ocfg = cells._opt_cfg_for(cfg)._replace(lr=LR, warmup_steps=1)
    mesh14 = make_mesh_compat((1, 4), ("data", "model"))
    step = jax.jit(ts.make_train_step(
        lambda p, i, l: recsys.widedeep_loss(p, i, l, cfg), ocfg))
    state = ts.init_state(jax.random.PRNGKey(1), params, ocfg)
    with mesh14:
        for s in range(STEPS):
            state, m = step(state, jnp.asarray(inp[f"ids{s}"]),
                            jnp.asarray(inp[f"labels{s}"]))
            out[f"loss{s}"] = np.asarray(m["loss"])
            out[f"grad_norm{s}"] = np.asarray(m["grad_norm"])
            for k, v in state.params.items():
                out[f"step{s}/" + k] = np.asarray(v)
    np.savez(os.path.join(d, "out.npz"), **out)
    print(json.dumps({"devices": jax.device_count()}))
""")


def _cfg(psum: bool = True):
    return configs.get("wide-deep").make_smoke()._replace(psum_lookup=psum)


def _batches(cfg, steps: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_per_field, (BATCH, cfg.n_sparse),
                          dtype=np.int64),
             (rng.random(BATCH) < 0.5).astype(np.float32))
            for _ in range(steps)]


def _lookup_inputs():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((V, DIM)).astype(np.float32)
    ids = rng.integers(0, V, NIDS).astype(np.int32)
    # dyadic cotangents: every gradient sum is exact in any order
    w = (rng.integers(-8, 9, NIDS + (DIM,)) / 8.0).astype(np.float32)
    return table, ids, w


@pytest.fixture(scope="module")
def jax_ref():
    table, ids, w = _lookup_inputs()
    inp = {"table": table, "ids": ids, "w": w}
    for s, (i, lab) in enumerate(_batches(_cfg(), STEPS)):
        inp[f"ids{s}"], inp[f"labels{s}"] = i.astype(np.int32), lab
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **inp)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu")
        res = subprocess.run(
            [sys.executable, "-c", CHILD, d, str(STEPS), str(LR)],
            capture_output=True, text=True, env=env, timeout=420)
        assert res.returncode == 0, res.stderr[-4000:]
        assert json.loads(res.stdout.splitlines()[-1])["devices"] == 8
        with np.load(os.path.join(d, "out.npz")) as f:
            return {k: f[k] for k in f.files}


def _mesh(data: int, model: int):
    return mesh_lib.make_mesh_compat((data, model), ("data", "model"),
                                     devices=("cpu",) * (data * model))


# -- sharded_lookup ------------------------------------------------------------


def test_sharded_lookup_forward_bit_equal_to_jax(jax_ref):
    table, ids, _ = _lookup_inputs()
    mesh = _mesh(2, 4)
    got = embedding.sharded_lookup(torch.from_numpy(table),
                                   torch.from_numpy(ids), mesh)
    np.testing.assert_array_equal(got.numpy(), jax_ref["lookup"])
    np.testing.assert_array_equal(got.numpy(), jax_ref["lookup_plain"])
    assert got.device == mesh.devices[0]


def test_sharded_lookup_gradient_equals_jax(jax_ref):
    table, ids, w = _lookup_inputs()
    mesh = _mesh(2, 4)
    leaf = pl.place(torch.from_numpy(table).requires_grad_(True),
                    embedding.table_sharding(mesh))
    assert len(leaf.pieces) == 4        # replicated over "data": held once
    out = embedding.sharded_lookup(leaf, torch.from_numpy(ids), mesh)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                leaf.pieces)
    got = leaf.sharding.gather(list(grads), leaf.shape)
    np.testing.assert_array_equal(got.numpy(), jax_ref["lookup_grad"])


def test_sharded_lookup_rows_go_to_their_shard():
    """Shard s owns rows [s·V/S, (s+1)·V/S): a piece's gradient is nonzero
    only on the rows its ids hit; ids < 0 read zeros."""
    mesh = _mesh(1, 4)
    t = torch.arange(V * 2, dtype=torch.float32).reshape(V, 2)
    leaf = pl.place(t.clone().requires_grad_(True),
                    embedding.table_sharding(mesh))
    ids = torch.tensor([0, 17, 63, -1])
    out = embedding.sharded_lookup(leaf, ids, mesh)
    assert torch.equal(out[:3], t[ids[:3]]) and torch.equal(
        out[3], torch.zeros(2))
    grads = torch.autograd.grad(out.sum(), leaf.pieces)
    hit = [[int(r) for r in torch.nonzero(g.sum(1)).flatten()]
           for g in grads]
    assert hit == [[0], [1], [], [15]]


@pytest.mark.parametrize("rows,shards", [(30, 4), (64, 3)])
def test_sharded_lookup_uneven_split_raises(rows, shards):
    mesh = _mesh(1, shards)
    with pytest.raises(ValueError, match="split"):
        embedding.sharded_lookup(torch.zeros(rows, 2), torch.zeros(3,
                                 dtype=torch.long), mesh)


def test_sharded_lookup_pieces_on_the_wrong_devices_raise():
    mesh = _mesh(1, 2)
    leaf = pl.Placed([torch.zeros(2, 2), torch.zeros(2, 2, device="meta")],
                     embedding.table_sharding(mesh), (4, 2))
    with pytest.raises(ValueError, match="piece 1"):
        embedding.sharded_lookup(leaf, torch.zeros(3, dtype=torch.long),
                                 mesh)


# -- Wide&Deep with psum_lookup=True -------------------------------------------


def _jax_params(ref, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _train(model, cfg, mesh, batches, state=None, start=0):
    ocfg = cells._opt_cfg_for(cfg)._replace(lr=LR, warmup_steps=1)
    step = ts.make_train_step(
        lambda p, i, l: recsys.widedeep_loss(p, i, l, cfg, mesh), ocfg,
        grad_shardings=None)
    state = state or ts.init_state(None, model, ocfg)
    losses = []
    for i, lab in batches[start:]:
        state, m = step(state, torch.from_numpy(i), torch.from_numpy(lab))
        losses.append(float(m["loss"]))
    return state, losses


def test_widedeep_psum_lookup_trains_as_jax(jax_ref):
    cfg = _cfg()
    mesh = _mesh(1, 4)
    model = convert.widedeep_params_from_numpy(
        _jax_params(jax_ref, "init/"), cfg, mesh=mesh)
    assert pl.is_placed(model.table) and pl.is_placed(model.wide)
    assert len(model.table.pieces) == 4
    assert model.table.pieces[0].shape == (cfg.total_vocab // 4,
                                           cfg.embed_dim)
    ocfg = cells._opt_cfg_for(cfg)._replace(lr=LR, warmup_steps=1)
    step = ts.make_train_step(
        lambda p, i, l: recsys.widedeep_loss(p, i, l, cfg, mesh), ocfg)
    state = ts.init_state(None, model, ocfg)
    for s, (i, lab) in enumerate(_batches(cfg, STEPS)):
        state, m = step(state, torch.from_numpy(i), torch.from_numpy(lab))
        want = float(jax_ref[f"loss{s}"])
        assert abs(float(m["loss"]) - want) <= TOL * abs(want), s
        assert float(m["grad_norm"]) == pytest.approx(
            float(jax_ref[f"grad_norm{s}"]), rel=TOL)
        for k, leaf in opt_lib.named_leaves(state.params).items():
            whole = leaf.gather() if pl.is_placed(leaf) else leaf
            np.testing.assert_allclose(whole.detach().numpy(),
                                       jax_ref[f"step{s}/{k}"], rtol=0,
                                       atol=TOL, err_msg=f"{s} {k}")


def test_widedeep_psum_lookup_equals_the_dense_lookup():
    """The same init and batches with and without the psum lookup: step-1
    logits and each piece's gradient bit-equal to its rows of the dense
    gradient; the losses of three AdamW steps within 1e-6."""
    cfg = _cfg()
    mesh = _mesh(1, 4)
    a = recsys.WideDeep.init(torch.Generator().manual_seed(3), cfg,
                             mesh=mesh)
    b = recsys.WideDeep.init(torch.Generator().manual_seed(3),
                             _cfg(False), device="cpu")
    i, lab = (torch.from_numpy(x) for x in _batches(cfg, 1)[0])
    assert torch.equal(recsys.widedeep_forward(a, i, cfg, mesh),
                       recsys.widedeep_forward(b, i, _cfg(False)))
    ga = torch.autograd.grad(recsys.widedeep_loss(a, i, lab, cfg, mesh),
                             a.table.pieces)
    gb = torch.autograd.grad(recsys.widedeep_loss(b, i, lab, _cfg(False)),
                             b.table)[0]
    for g, idx in zip(ga, a.table.indices):
        assert torch.equal(g, gb[idx])
    batches = _batches(cfg, STEPS)
    _, la = _train(a, cfg, mesh, batches)
    _, lb = _train(b, _cfg(False), None, batches)
    assert np.allclose(la, lb, rtol=TOL, atol=0)


def test_widedeep_mesh_is_only_for_psum_lookup():
    with pytest.raises(ValueError, match="psum_lookup=True only"):
        recsys.WideDeep.init(torch.Generator().manual_seed(0), _cfg(False),
                             mesh=_mesh(1, 2))


def test_elastic_resume_four_two_one_shards(tmp_path):
    """A's step-2 checkpoint (one ``table`` entry, rows in order: the JAX
    layout) restored at 2 shards and at 1 reaches step 4 within 1e-6 of
    the straight run's losses."""
    cfg = _cfg()
    batches = _batches(cfg, 4, seed=11)
    mesh4 = _mesh(1, 4)
    model = recsys.WideDeep.init(torch.Generator().manual_seed(5), cfg,
                                 mesh=mesh4)
    state, first = _train(model, cfg, mesh4, batches[:2])
    ckpt.save(str(tmp_path), 2, state._replace(rng=None))
    with np.load(tmp_path / "step_0000000002" / "arrays.npz") as f:
        keys = set(f.files)
        table = f["params/table"]
    assert {"params/table", "params/wide", "opt_state/mu/table",
            "opt_state/nu/table"} <= keys
    assert not any(k.startswith("params/table/") for k in keys)
    np.testing.assert_array_equal(table, model.table.gather().numpy())
    state, rest = _train(model, cfg, mesh4, batches, state, start=2)
    straight = first + rest
    for shards in (2, 1):
        mesh = _mesh(1, shards)
        fresh = recsys.WideDeep.init(torch.Generator().manual_seed(99), cfg,
                                     mesh=mesh)
        ocfg = cells._opt_cfg_for(cfg)._replace(lr=LR, warmup_steps=1)
        like = ts.init_state(None, fresh, ocfg)._replace(rng=None)
        restored, _ = ckpt.restore(str(tmp_path), 2, like)
        assert len(restored.opt_state.mu["table"].pieces) == shards
        with torch.no_grad():
            for k, p in opt_lib.named_leaves(fresh).items():
                p.copy_(restored.params[k])
        st = ts.TrainState(params=fresh, opt_state=restored.opt_state,
                           step=restored.step, rng=None)
        _, resumed = _train(fresh, cfg, mesh, batches, st, start=2)
        assert np.allclose(resumed, straight[2:], rtol=TOL, atol=0), shards


# -- placed leaves through the optimizer ---------------------------------------


def _adafactor_cfg():
    return opt_lib.OptimizerConfig(name="adafactor", lr=1e-2,
                                   warmup_steps=1, grad_clip=0.0,
                                   weight_decay=0.1)


@pytest.mark.parametrize("shape,spec", [((32, 6), ("model", None)),
                                        ((4, 6, 5), ("model", None, None)),
                                        ((16,), ("model",))])
def test_adafactor_piece_by_piece_equals_the_whole_leaf(shape, spec):
    mesh = _mesh(1, 4 if shape[0] % 4 == 0 else 2)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(shape, generator=g)
    grads = [torch.randn(shape, generator=g) for _ in range(3)]
    whole = {"w": w.clone().requires_grad_(True)}
    placed = {"w": pl.place(w.clone().requires_grad_(True),
                            sh.NamedSharding(mesh, sh.P(*spec)))}
    ocfg = _adafactor_cfg()
    sw, sp = opt_lib.init(whole, ocfg), opt_lib.init(placed, ocfg)
    assert pl.is_placed(sp.mu["w"])             # the row stat splits
    for gr in grads:
        _, sw = opt_lib.update({"w": gr.clone()}, sw, whole, ocfg)
        gp = placed["w"].like([gr[idx].clone()
                               for idx in placed["w"].indices])
        _, sp = opt_lib.update({"w": gp}, sp, placed, ocfg)
    np.testing.assert_allclose(placed["w"].gather().numpy(),
                               whole["w"].detach().numpy(), atol=TOL,
                               rtol=0)


def test_adafactor_split_on_the_last_axes_raises():
    mesh = _mesh(1, 2)
    leaf = pl.place(torch.zeros(4, 6, requires_grad=True),
                    sh.NamedSharding(mesh, sh.P(None, "model")))
    ocfg = _adafactor_cfg()
    state = opt_lib.init({"w": leaf}, ocfg)
    with pytest.raises(NotImplementedError, match="item 11b"):
        opt_lib.update({"w": leaf.like([torch.ones(4, 3)] * 2)}, state,
                       {"w": leaf}, ocfg)


def test_global_norm_sums_the_pieces():
    mesh = _mesh(1, 4)
    g = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    leaf = pl.place(g, embedding.table_sharding(mesh))
    other = torch.randn(5)
    got = opt_lib.global_norm({"a": other, "t": leaf})
    want = opt_lib.global_norm({"a": other, "t": g})
    assert float(got) == pytest.approx(float(want), rel=TOL)


# -- the pipeline's shardings --------------------------------------------------


@pytest.mark.parametrize("prefetch", [False, True])
def test_pipeline_shardings_lay_out_each_batch(prefetch):
    """A leaf whose spec splits nothing comes out as one tensor on the
    mesh's first device, a split leaf as its pieces in mesh order; the
    stream equals the unsharded pipeline's."""
    mesh = _mesh(2, 2)
    rows = sh.NamedSharding(mesh, sh.logical_to_spec(
        ("act_batch", None), sh.RECSYS_BASE_RULES, mesh, (8, 3)))
    repl = sh.NamedSharding(mesh, sh.P())

    def make(g):
        return (torch.randint(0, 9, (8, 3), generator=g),
                torch.rand(8, generator=g))

    plain = pipe_lib.Pipeline(make, seed=4, device="cpu")
    laid = pipe_lib.Pipeline(make, seed=4, device="cpu", prefetch=prefetch,
                             shardings=(rows, repl))
    try:
        for _ in range(3):
            (ids, lab), (pieces, lab2) = next(plain), next(laid)
            assert isinstance(pieces, list) and len(pieces) == 4
            assert torch.equal(pieces[0], ids[:4])
            assert torch.equal(pieces[2], ids[4:])
            assert pieces[0] is pieces[1]          # one tensor a slice
            assert torch.equal(rows.gather(pieces), ids)
            assert torch.equal(lab2, lab)
    finally:
        laid.close()
