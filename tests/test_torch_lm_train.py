"""The port's LM training slice on the CPU against the JAX package, on the
same numpy inputs at smoke widths: ``layers.softmax_xent_chunked`` and
``blockwise_attention`` (with autograd recording and without),
``transformer.forward_train`` with and without the KV-PQ distortion term,
the optimizer's stacked (L, n, n) rotations, its ``moment_dtype`` and
``compute_dtype``, ``global_norm`` on bf16 gradients, three train steps,
``data.synthetic.lm_batch`` and the launcher ``launch.train``.

JAX leaves are carried across by ``convert.transformer_params_from_numpy``.
Tolerances: losses within 1e-5 relative, gradients within 1e-5 of each
leaf's largest entry (float32 models of two layers, summed in another
order by XLA and PyTorch); the stacked GCD-G step on a Hadamard R and a
dyadic G, where the score field is exact, so the matchings must agree.
"""
from __future__ import annotations

import re
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
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_state as jts
from repro_torch import configs, convert, rotations
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_state as ts

LM_ARCHS = ["olmo-1b", "qwen1.5-4b", "nemotron-4-340b"]


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


def _close(got, want, rel: float, what: str = "") -> None:
    """|got − want| ≤ rel · max|want| elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _trainable(params: dict) -> dict:
    for leaf in opt_lib.named_leaves(params).values():
        leaf.requires_grad_(True)
    return params


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 32, 1000])
def test_softmax_xent_chunked_value_and_grads_match_jax(chunk):
    """Value and the gradients wrt x and head against JAX's, at chunks that
    split T into 4, 1 and (clamped) 1 pieces."""
    rng = np.random.default_rng(chunk)
    T, d, V = 32, 12, 50
    x = rng.standard_normal((T, d)).astype(np.float32)
    head = rng.standard_normal((V, d)).astype(np.float32)
    lab = rng.integers(0, V, T).astype(np.int32)
    jv, (jgx, jgh) = jax.value_and_grad(
        lambda a, b: jlayers.softmax_xent_chunked(a, b, jnp.asarray(lab),
                                                  chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx, th = _t(x).requires_grad_(True), _t(head).requires_grad_(True)
    v = layers.softmax_xent_chunked(tx, th, _t(lab), chunk=chunk)
    assert v.dtype == torch.float32 and v.dim() == 0
    gx, gh = torch.autograd.grad(v, (tx, th))
    assert abs(float(v.detach()) - float(jv)) <= 1e-6 * abs(float(jv))
    _close(gx, jgx, 1e-5, "dx")
    _close(gh, jgh, 1e-5, "dhead")
    with torch.no_grad():
        assert float(layers.softmax_xent_chunked(
            tx, th, _t(lab), chunk=chunk)) == float(v)


def test_softmax_xent_chunked_raises_on_a_ragged_chunk():
    x, head = torch.zeros(30, 4), torch.zeros(7, 4)
    with pytest.raises(ValueError, match="divisible"):
        layers.softmax_xent_chunked(x, head, torch.zeros(30, dtype=torch.long),
                                    chunk=8)


@pytest.mark.parametrize("hq,hkv,q_chunk", [(4, 4, 8), (4, 2, 16), (6, 2, 32)])
def test_blockwise_attention_matches_jax_with_grad_on_and_off(hq, hkv,
                                                              q_chunk):
    """Outputs equal with autograd recording (each chunk checkpointed) and
    without; the gradients wrt q, k and v against JAX's."""
    rng = np.random.default_rng(hq * 10 + hkv)
    B, S, hd = 2, 32, 8
    q = rng.standard_normal((B, S, hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, hd)).astype(np.float32)
    dy = rng.standard_normal((B, S, hq, hd)).astype(np.float32)

    def jfn(a, b, c):
        out = jlayers.blockwise_attention(a, b, c, q_chunk=q_chunk)
        return jnp.sum(out * jnp.asarray(dy)), out

    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with torch.no_grad():
        off = layers.blockwise_attention(_t(q), _t(k), _t(v),
                                         q_chunk=q_chunk)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    on = layers.blockwise_attention(tq, tk, tv, q_chunk=q_chunk)
    assert on.grad_fn is not None
    assert torch.equal(on.detach(), off)
    _close(on, jout, 1e-6, "out")
    grads = torch.autograd.grad(on, (tq, tk, tv), _t(dy))
    for name, g, w in zip("qkv", grads, jg):
        _close(g, w, 1e-5, f"d{name}")


# -- forward_train ------------------------------------------------------------


def _lm_pair(arch: str, kvq: bool, seed: int = 0, bf16: bool = False):
    """The JAX smoke config and params, and the port's, the leaves carried
    across; kvq adds KVQuantConfig(hd, D, 16) with train_kv_quant; bf16
    stores and computes the model in bfloat16."""
    jcfg = jconfigs.get(arch).make_smoke()
    cfg = configs.get(arch).make_smoke()
    if bf16:
        jcfg = jcfg._replace(param_dtype=jnp.bfloat16, dtype=jnp.bfloat16)
        cfg = cfg._replace(param_dtype=torch.bfloat16, dtype=torch.bfloat16)
    if kvq:
        hd = cfg.head_dim
        D = 4 if hd % 4 == 0 else 3
        jcfg = jcfg._replace(kv_quant=JKVQuantConfig(hd, D, 16),
                             train_kv_quant=True)
        cfg = cfg._replace(kv_quant=KVQuantConfig(hd, D, 16),
                           train_kv_quant=True)
    jp = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    p = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, _trainable(p)


@pytest.mark.parametrize("kvq", [False, True], ids=["dense", "kvq"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, kvq):
    """Loss (1e-5 relative) and every leaf's gradient (1e-5 of its largest
    entry) against JAX's; remat on and off give the same loss and
    gradients; with the KV term the kvq leaves get a nonzero gradient."""
    jcfg, jp, cfg, p = _lm_pair(arch, kvq)
    rng = np.random.default_rng(1)
    B, S = 2, 32
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda pp: jtfm.forward_train(
        pp, jnp.asarray(tok), jnp.asarray(lab), jcfg))(jp)
    jg = _flat(jg)
    leaves = opt_lib.named_leaves(p)
    assert set(leaves) == set(jg)
    out = {}
    for remat in (True, False):
        loss = tfm.forward_train(p, _t(tok), _t(lab),
                                 cfg._replace(remat=remat))
        assert loss.dtype == torch.float32
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[remat] = (loss.detach(), dict(zip(leaves, grads)))
        assert abs(float(out[remat][0]) - float(jl)) <= 1e-5 * abs(float(jl))
        for k, g in out[remat][1].items():
            _close(g, jg[k], 1e-5, k)
    assert torch.equal(out[True][0], out[False][0])
    for k in leaves:
        torch.testing.assert_close(out[True][1][k], out[False][1][k],
                                   atol=1e-7, rtol=1e-6)
    if kvq:
        for k in ("kvq/rot_k", "kvq/rot_v", "kvq/cb_k", "kvq/cb_v"):
            assert float(out[True][1][k].abs().max()) > 0, k


def test_kv_term_is_the_distortion_and_the_assignment_carries_no_gradient():
    """forward_train with the KV term less without it is 0.1·Σ dist / L;
    the term's codebook gradient is the one of the fixed assignment: the
    same codes, with the codebooks moved, give the same gradient."""
    _, _, cfg, p = _lm_pair("olmo-1b", True)
    rng = np.random.default_rng(2)
    tok = _t(rng.integers(0, cfg.vocab_size, (2, 16)))
    lab = _t(rng.integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        both = tfm.forward_train(p, tok, lab, cfg)
        plain = tfm.forward_train(p, tok, lab,
                                  cfg._replace(train_kv_quant=False))
        assert float(both) > float(plain)
    from repro_torch.core import kv_quant
    from repro_torch.quant import codebook as cb
    kvp = kv_quant.KVQuantParams(*(p["kvq"][k][0] for k in
                                   ("rot_k", "rot_v", "cb_k", "cb_v")))
    X = _t(rng.standard_normal((64, cfg.head_dim)).astype(np.float32))
    d = kv_quant.kv_distortion(kvp, X, X)
    g_rk, g_ck = torch.autograd.grad(d, (p["kvq"]["rot_k"], p["kvq"]["cb_k"]))
    assert float(g_rk[0].abs().max()) > 0 and float(g_rk[1:].abs().max()) == 0
    XR = (X @ kvp.rot_k).detach()
    codes = cb.assign(XR, kvp.cb_k.detach())
    C = kvp.cb_k.detach().clone().requires_grad_(True)
    want = torch.autograd.grad(cb.distortion(XR, C, codes), C)[0]
    torch.testing.assert_close(g_ck[0], want, atol=1e-7, rtol=1e-6)


# -- the optimizer ------------------------------------------------------------


def _hadamard(n: int) -> np.ndarray:
    H = np.ones((1, 1))
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return (H / np.sqrt(n)).astype(np.float32)


def _stacked_rot_problem(L: int = 3, n: int = 16, seed: int = 0):
    """Per-layer Hadamard rotations (rows permuted per layer) and dyadic
    gradients, so A = GᵀR − RᵀG is exact in float32."""
    rng = np.random.RandomState(seed)
    H = _hadamard(n)
    R = np.stack([H[rng.permutation(n)] for _ in range(L)])
    params = {"kvq": {"rot_k": R, "rot_v": R[::-1].copy()},
              "w": rng.randn(4, 8).astype(np.float32)}
    grads = {"kvq": {k: (rng.randint(-4, 5, size=(L, n, n)) / 4.0)
                     .astype(np.float32) for k in ("rot_k", "rot_v")},
             "w": rng.randn(4, 8).astype(np.float32)}
    return params, grads


def test_stacked_gcd_update_matches_jax_update_with_deltas():
    """One GCD-G step of stacked (L, n, n) rotations against the JAX
    package's vmapped update: the same pairs, angles (1e-6), R (1e-6),
    the stacked learner state and the deltas stacked on L; R stays
    orthogonal."""
    params, grads = _stacked_rot_problem()
    rcfg = dict(learner="gcd", method="greedy", lr=5e-2)
    jcfg = jopt.OptimizerConfig(lr=1e-2, grad_clip=0.0, warmup_steps=1,
                                rotation=jrot.RotationConfig(**rcfg))
    tcfg = opt_lib.OptimizerConfig(lr=1e-2, grad_clip=0.0, warmup_steps=1,
                                   rotation=rotations.RotationConfig(**rcfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp, jcfg)
    jp2, jstate2, jd = jopt.update_with_deltas(
        jax.tree.map(jnp.asarray, grads), jstate, jp, jcfg,
        jax.random.PRNGKey(0))
    tp = {"kvq": {k: _t(v) for k, v in params["kvq"].items()},
          "w": _t(params["w"])}
    tstate = opt_lib.init(tp, tcfg)
    assert tuple(tstate.rot["kvq/rot_k"].R.shape) == (3, 16, 16)
    assert tuple(tstate.rot["kvq/rot_k"].step.shape) == (3,)
    tg = {"kvq/rot_k": _t(grads["kvq"]["rot_k"]),
          "kvq/rot_v": _t(grads["kvq"]["rot_v"]), "w": _t(grads["w"])}
    tp2, tstate2, td = opt_lib.update_with_deltas(tg, tstate, tp, tcfg)
    for k in ("rot_k", "rot_v"):
        key = f"kvq/{k}"
        jdel, tdel = jd[key], td[key]
        assert tuple(tdel.pi.shape) == tuple(jdel.pi.shape) == (3, 8)
        np.testing.assert_array_equal(tdel.pi.numpy(), np.asarray(jdel.pi))
        np.testing.assert_array_equal(tdel.pj.numpy(), np.asarray(jdel.pj))
        np.testing.assert_allclose(tdel.theta.numpy(), np.asarray(jdel.theta),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(tp2["kvq"][k].numpy(),
                                   np.asarray(jp2["kvq"][k]), atol=1e-6)
        for f in jstate2.rot[key]._fields:
            np.testing.assert_allclose(
                getattr(tstate2.rot[key], f).numpy(),
                np.asarray(getattr(jstate2.rot[key], f)), atol=1e-6,
                err_msg=f"{key} {f}")
        for r in tp2["kvq"][k]:
            assert float(rotations.orthogonality_error(r)) < 1e-5
            assert float((r - torch.eye(16)).abs().max()) > 0
    np.testing.assert_allclose(tp2["w"].numpy(), np.asarray(jp2["w"]),
                               atol=1e-6)


def test_stacked_random_learner_draws_once_per_layer():
    """GCD-R on a stacked leaf: each layer takes its own draw from the one
    generator (the layers' pairs differ), and the same seed repeats the
    step."""
    params, grads = _stacked_rot_problem(L=4)
    cfg = opt_lib.OptimizerConfig(lr=0.0, grad_clip=0.0, rotation=rotations
                                  .RotationConfig(learner="gcd_random",
                                                  lr=1e-2))
    out = []
    for _ in range(2):
        tp = {"kvq": {"rot_k": _t(params["kvq"]["rot_k"])}}
        st = opt_lib.init(tp, cfg)
        g = torch.Generator().manual_seed(7)
        _, _, d = opt_lib.update_with_deltas(
            {"kvq/rot_k": _t(grads["kvq"]["rot_k"])}, st, tp, cfg, g)
        out.append((tp["kvq"]["rot_k"].clone(), d["kvq/rot_k"]))
    pairs = {tuple(out[0][1].pi[i].tolist()) for i in range(4)}
    assert len(pairs) == 4
    assert torch.equal(out[0][0], out[1][0])


@pytest.mark.parametrize("moment,compute", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["f32_f32", "bf16_f32",
                                            "bf16_bf16"])
def test_adamw_moment_and_compute_dtype_match_jax(moment, compute):
    """Two AdamW steps on bf16 parameters with bf16 gradients, the moments
    stored in ``moment_dtype`` and the update computed in
    ``compute_dtype``, against the JAX package: parameters and moments in
    their dtypes, within one bf16 rounding (2⁻⁸ relative) of JAX's where
    bf16 arithmetic is involved and within float32 rounding (1e-6; the
    clip's norm is summed in another order) otherwise."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((6, 8)).astype(np.float32),
         "b": rng.standard_normal(8).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
           p.items()} for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0, weight_decay=0.01)
    jcfg = jopt.OptimizerConfig(moment_dtype=jdt[moment],
                                compute_dtype=jdt[compute], **kw)
    tcfg = opt_lib.OptimizerConfig(moment_dtype=moment, compute_dtype=compute,
                                   **kw)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jstate = jopt.init(jp, jcfg)
    tp = {k: _t(v).to(torch.bfloat16) for k, v in p.items()}
    tstate = opt_lib.init(tp, tcfg)
    assert all(m.dtype == moment for m in tstate.mu.values())
    for g in gs:
        jp, jstate = jopt.update({k: jnp.asarray(v, jnp.bfloat16)
                                  for k, v in g.items()}, jstate, jp, jcfg,
                                 jax.random.PRNGKey(0))
        tp, tstate = opt_lib.update({k: _t(v).to(torch.bfloat16)
                                     for k, v in g.items()}, tstate, tp, tcfg)
    rel = 1e-6 if moment == compute == torch.float32 else 2.0 ** -8
    for k in p:
        assert tp[k].dtype == torch.bfloat16
        for got, want in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                          (tstate.nu[k], jstate.nu[k])):
            want = np.asarray(want, dtype=np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=rel,
                                       atol=rel * float(np.abs(want).max()),
                                       err_msg=k)


def test_global_norm_accumulates_bf16_gradients_in_float32():
    """A bf16 gradient's squares summed in float32 (JAX's
    preferred_element_type), not in bf16: 4,096 entries of 0.5 and one
    large leaf give the float64 norm of the bf16 values to 1e-6."""
    rng = np.random.default_rng(5)
    g = {"a": torch.full((4096,), 0.5, dtype=torch.bfloat16),
         "b": _t(rng.standard_normal((64, 64)).astype(np.float32)).to(
             torch.bfloat16)}
    got = opt_lib.global_norm(g)
    assert got.dtype == torch.float32
    want64 = np.sqrt(sum(float(np.sum(v.double().numpy() ** 2))
                         for v in g.values()))
    assert abs(float(got) - want64) <= 1e-6 * want64
    jn = jopt.global_norm({k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
                           for k, v in g.items()})
    assert abs(float(got) - float(jn)) <= 1e-5 * want64
    naive = torch.sqrt(sum(torch.dot(v.reshape(-1), v.reshape(-1))
                           for v in g.values()))
    assert naive.dtype == torch.bfloat16     # what the float32 sum avoids


def test_three_train_steps_match_jax():
    """Three make_train_step steps of olmo-1b's smoke config with the KV
    term and GCD-G on the stacked kvq rotations, on the JAX package's
    batch stream: each step's loss (1e-5), the gradient norm (1e-4), and
    the parameters after (1e-4 of each leaf's largest entry); the kvq
    rotations moved and orthogonal."""
    jcfg, jp, cfg, p = _lm_pair("olmo-1b", True, seed=3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jocfg = jopt.OptimizerConfig(**kw, rotation=jrot.RotationConfig(
        learner="gcd", method="greedy", lr=1e-2))
    tocfg = opt_lib.OptimizerConfig(**kw, rotation=rotations.RotationConfig(
        learner="gcd", method="greedy", lr=1e-2))
    jstep = jax.jit(jts.make_train_step(
        lambda pp, a, b: jtfm.forward_train(pp, a, b, jcfg), jocfg))
    tstep = ts.make_train_step(
        lambda pp, a, b: tfm.forward_train(pp, a, b, cfg), tocfg)
    jstate = jts.init_state(jax.random.PRNGKey(0), jp, jocfg)
    tstate = ts.init_state(None, p, tocfg)
    R0 = p["kvq"]["rot_k"].detach().clone()
    for i in range(3):
        tok, lab = jsynth.lm_batch(jax.random.PRNGKey(10 + i), 2, 16,
                                   cfg.vocab_size)
        jstate, jm = jstep(jstate, tok, lab)
        tstate, tm = tstep(tstate, _t(tok), _t(lab))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"])), i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"]), i
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    for k, v in opt_lib.named_leaves(tstate.params).items():
        _close(v, want[k], 1e-4, k)
    Rk = tstate.params["kvq"]["rot_k"].detach()
    assert float((Rk - R0).abs().max()) > 0
    for r in Rk:
        assert float(rotations.orthogonality_error(r)) < 1e-5


# -- data ---------------------------------------------------------------------


def test_lm_batch_shapes_shift_and_zipf_head():
    """(batch, seq) int64 tokens and labels, the labels the tokens shifted
    by one within a row of one (batch, seq + 1) draw, ids in [0, V), token
    0's share within 5σ of 1 / Σ r^−1.1, and a seed repeats the batch."""
    V, B, S = 1000, 64, 128
    g = torch.Generator().manual_seed(0)
    tok, lab = synthetic.lm_batch(g, B, S, V)
    assert tok.shape == lab.shape == (B, S)
    assert tok.dtype == lab.dtype == torch.int64
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    assert int(tok.min()) >= 0 and int(max(tok.max(), lab.max())) < V
    p0 = 1.0 / float(np.sum(np.arange(1, V + 1, dtype=np.float64) ** -1.1))
    n = B * (S + 1)
    share = float((torch.cat([tok, lab[:, -1:]], 1) == 0).float().mean())
    assert abs(share - p0) <= 5 * np.sqrt(p0 * (1 - p0) / n)
    assert float((tok == 1).float().mean()) < share
    t2, _ = synthetic.lm_batch(torch.Generator().manual_seed(0), B, S, V)
    assert torch.equal(tok, t2)


# -- the launcher -------------------------------------------------------------


@pytest.fixture
def deterministic():
    """Deterministic algorithms for the block (the multi-threaded CPU sums
    of the LM's backward otherwise part by an ulp run to run), the
    caller's mode restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("arch,batch", [("two-tower-retrieval", 8),
                                        ("olmo-1b", 4), ("grok-1-314b", 4)])
def test_train_launcher_resume_exact(arch, batch, deterministic):
    """The JAX launcher's contract (tests/test_training.py): six steps
    straight against the same job crashed after three and resumed from
    its checkpoint end at the same loss (rtol 1e-4); under deterministic
    algorithms the parameters end bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        state_a, hist_a = launch.train(arch, steps=6, batch=batch,
                                       ckpt_dir=None, seed=3, log_every=100,
                                       device="cpu")
        _, hist_c = launch.train(arch, steps=6, batch=batch, ckpt_dir=d,
                                 seed=3, ckpt_every=100, log_every=100,
                                 stop_after=3, device="cpu")
        assert len(hist_c) == 3 and ckpt.latest_step(d) == 3
        state_b, hist_b = launch.train(arch, steps=6, batch=batch,
                                       ckpt_dir=d, seed=3, ckpt_every=100,
                                       log_every=100, device="cpu")
        assert len(hist_b) == 3 and ckpt.latest_step(d) == 6
    assert np.isclose(hist_a[-1], hist_b[-1], rtol=1e-4), (hist_a, hist_b)
    a, b = (opt_lib.named_leaves(s.params) for s in (state_a, state_b))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert state_b.step == state_a.step == 6


def test_train_launcher_prefetch_resume_exact():
    """Crash after three with prefetch on, resume with prefetch on: the
    loss of the uninterrupted prefetch-off run (the cursor does not depend
    on the prefetch)."""
    with tempfile.TemporaryDirectory() as d:
        _, hist_a = launch.train("two-tower-retrieval", steps=6, batch=8,
                                 ckpt_dir=None, seed=3, log_every=100,
                                 device="cpu")
        launch.train("two-tower-retrieval", steps=6, batch=8, ckpt_dir=d,
                     seed=3, ckpt_every=100, log_every=100, stop_after=3,
                     prefetch=True, device="cpu")
        _, hist_b = launch.train("two-tower-retrieval", steps=6, batch=8,
                                 ckpt_dir=d, seed=3, ckpt_every=100,
                                 log_every=100, prefetch=True, device="cpu")
    assert np.isclose(hist_a[-1], hist_b[-1], rtol=1e-4), (hist_a, hist_b)


@pytest.mark.parametrize("arch", ["din", "graphsage-reddit", "mind",
                                  "wide-deep"])
def test_train_launcher_zoo_families_train(arch):
    """The zoo's families through the launcher at the smoke config: 40
    steps of batch 64, every loss finite, the last five below the first
    five on average."""
    _, hist = launch.train(arch, steps=40, batch=64, ckpt_dir=None, seed=0,
                           log_every=100, device="cpu")
    assert len(hist) == 40 and np.all(np.isfinite(hist))
    assert np.mean(hist[-5:]) < np.mean(hist[:5]), hist


def test_train_launcher_obs_log_and_main(tmp_path, capsys):
    """``main`` on the CPU with an obs log: the JAX launcher's names (the
    train.step span, train.loss and train.grad_norm gauges, train_step
    events) and the final-loss line; the loss falls over 8 steps."""
    from repro_torch import obs
    log = tmp_path / "events.jsonl"
    try:
        launch.main(["--arch", "olmo-1b", "--steps", "8", "--batch", "4",
                     "--device", "cpu", "--obs-log", str(log)])
        reg = obs.default_registry()
        snap = obs.report()
    finally:
        obs.disable()
    out = capsys.readouterr().out
    assert "final loss" in out
    m = re.search(r"final loss: (\S+) \(start (\S+)\)", out)
    final, start = float(m.group(1)), float(m.group(2))
    assert final < start
    assert "train.step" in snap and "train.loss" in snap
    events = obs.read_jsonl(str(log))
    assert any(e.get("kind") == "train_step" for e in events)
    del reg


def test_rotation_health_reads_every_layer_of_a_stacked_leaf():
    params, _ = _stacked_rot_problem()
    tp = {"kvq": {k: _t(v) for k, v in params["kvq"].items()},
          "w": _t(params["w"])}
    assert launch._rotation_health(tp) < 1e-6
    tp["kvq"]["rot_v"][2, 0, 0] += 0.01
    assert launch._rotation_health(tp) > 1e-3


def _np_of(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX package's numpy leaf: bfloat16 as
    ``ml_dtypes`` bfloat16, bit for bit."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _as_saved(a) -> np.ndarray:
    """What ``np.load`` returns for a leaf the JAX package saved: a
    bfloat16 array's raw 2-byte elements (``|V2``), else the array."""
    a = np.asarray(a)
    return a.view(np.dtype("V2")) if a.dtype == jnp.bfloat16 else a


def _checkpoints_read_across_packages(bf16: bool) -> None:
    """An OptState with stacked GCD states (olmo-1b smoke with kvq, its
    leaves in float32 or bfloat16) after one step: written by the JAX
    package and read by the port, and written by the port and read by the
    JAX package, every leaf's dtype and value equal."""
    jcfg, jp, cfg, p = _lm_pair("olmo-1b", True, bf16=bf16)
    rcfg = dict(learner="gcd", method="greedy", lr=1e-2)
    jocfg = jopt.OptimizerConfig(rotation=jrot.RotationConfig(**rcfg))
    tocfg = opt_lib.OptimizerConfig(rotation=rotations.RotationConfig(
        **rcfg))
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jp)
    _, jstate = jopt.update(grads, jopt.init(jp, jocfg), jp, jocfg,
                            jax.random.PRNGKey(0))
    like = opt_lib.init(p, tocfg)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 1, {"opt": jstate})
        got, _ = ckpt.restore(d, 1, {"opt": like})
        mine, _ = jckpt.restore(d, 1, {"opt": jopt.init(jp, jocfg)})
    got = got["opt"]
    assert got.step == 1
    for key in ("kvq/rot_k", "kvq/rot_v"):
        st = got.rot[key]
        assert tuple(st.R.shape) == (cfg.num_layers, cfg.head_dim,
                                     cfg.head_dim)
        for f in st._fields:
            want = np.asarray(getattr(jstate.rot[key], f))
            assert _np_of(getattr(st, f)).dtype == want.dtype, f
            np.testing.assert_array_equal(_np_of(getattr(st, f)), want,
                                          err_msg=f)
    jmu = _flat(jax.tree.map(np.asarray, jstate.mu))
    for k, v in got.mu.items():
        np.testing.assert_array_equal(v.numpy(), jmu[k], err_msg=k)
    # and back: the port's state after one of its own steps, read by JAX
    # as JAX reads its own file (the same dtypes, the same bytes)
    tg = {k: _t(np.asarray(v)) for k, v in _flat(grads).items()}
    _, tstate = opt_lib.update(tg, opt_lib.init(p, tocfg), p, tocfg)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"opt": tstate})
        back, _ = jckpt.restore(d, 1, {"opt": jopt.init(jp, jocfg)})
    for key in ("kvq/rot_k", "kvq/rot_v"):
        for f in tstate.rot[key]._fields:
            read = np.asarray(getattr(back["opt"].rot[key], f))
            assert read.dtype == np.asarray(
                getattr(mine["opt"].rot[key], f)).dtype, f
            np.testing.assert_array_equal(
                read, _as_saved(_np_of(getattr(tstate.rot[key], f))),
                err_msg=f)
    conv = convert.opt_state_from_numpy(
        {"mu": _flat(back["opt"].mu), "nu": _flat(back["opt"].nu),
         "step": back["opt"].step,
         "rot": {k: {f: _np_of(getattr(tstate.rot[k], f)) if bf16 else a
                     for f, a in v._asdict().items()}
                 for k, v in back["opt"].rot.items()}},
        tocfg, device="cpu")
    for key in ("kvq/rot_k", "kvq/rot_v"):
        assert conv.rot[key].R.dtype == tstate.rot[key].R.dtype
        assert torch.equal(conv.rot[key].R, tstate.rot[key].R)


def test_stacked_gcd_state_checkpoints_read_across_packages():
    """The float32 case of ``_checkpoints_read_across_packages``."""
    _checkpoints_read_across_packages(bf16=False)


def test_bf16_gcd_state_checkpoints_read_across_packages():
    """The bfloat16 case (14c): a bf16 rotation's state R is bf16 in
    both packages and crosses the npz bit for bit; the accumulators stay
    float32."""
    _checkpoints_read_across_packages(bf16=True)


#: bf16's unit roundoff
BF16_U = 2.0 ** -8


def test_bf16_rotation_state_is_the_leaf_after_every_step_as_in_jax():
    """14c: three GCD-G steps of the bf16 olmo-1b smoke config with kvq in
    both packages on the same bf16 gradients. The state's R has the
    leaf's dtype (bf16, as JAX's) and the accumulators float32; state and
    leaf are bit-equal after every step; the port's R (rotated in float32
    and rounded once) is within 6u a step of JAX's (rotated in bf16
    arithmetic: c and s rounded, two products and a sum, each rounding a
    relative u = 2⁻⁸ at most)."""
    jcfg, jp, cfg, p = _lm_pair("olmo-1b", True, bf16=True)
    rcfg = dict(learner="gcd", method="greedy", lr=1e-2)
    jocfg = jopt.OptimizerConfig(grad_clip=0.0,
                                 rotation=jrot.RotationConfig(**rcfg))
    tocfg = opt_lib.OptimizerConfig(grad_clip=0.0,
                                    rotation=rotations.RotationConfig(**rcfg))
    jstate, tstate = jopt.init(jp, jocfg), opt_lib.init(p, tocfg)
    rng = np.random.default_rng(3)
    keys = ("kvq/rot_k", "kvq/rot_v")
    for step in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
            a.shape).astype(np.float32)).astype(a.dtype), jp)
        jp, jstate = jopt.update(grads, jstate, jp, jocfg,
                                 jax.random.PRNGKey(step))
        tg = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
            p_leaf.dtype) for (k, v), p_leaf in zip(
                _flat(grads).items(), _flat(p).values())}
        with torch.no_grad():
            _, tstate = opt_lib.update(tg, tstate, p, tocfg)
        for key in keys:
            jst, tst = jstate.rot[key], tstate.rot[key]
            leaf = p["kvq"][key.split("/")[1]]
            for f in jst._fields:
                assert _np_of(getattr(tst, f)).dtype == \
                    np.asarray(getattr(jst, f)).dtype, (step, key, f)
            assert tst.R.dtype == leaf.dtype == torch.bfloat16
            assert tst.accum.dtype == torch.float32
            assert torch.equal(tst.R, leaf), (step, key)
            assert tst.R.data_ptr() != leaf.data_ptr()
            np.testing.assert_array_equal(
                np.asarray(jst.R), np.asarray(jp["kvq"][key.split("/")[1]]))
            gap = float(np.max(np.abs(np.asarray(jst.R, np.float32)
                                      - tst.R.float().numpy())))
            assert gap <= 6 * BF16_U * (step + 1), (step, key, gap)


def test_forward_train_launches_nothing_on_the_cpu():
    """The CPU path takes the plain versions: no kernel is counted."""
    _, _, cfg, p = _lm_pair("olmo-1b", True)
    before = dict(ops.LAUNCHES)
    tok = torch.zeros((1, 16), dtype=torch.long)
    loss = tfm.forward_train(p, tok, tok, cfg)
    torch.autograd.grad(loss, [p["kvq"]["rot_k"]])
    assert dict(ops.LAUNCHES) == before


def test_train_launcher_without_a_card_raises(monkeypatch):
    """Called without ``device=`` on a machine without a card, the
    launcher raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.train("olmo-1b", steps=1, batch=2, ckpt_dir=None)
