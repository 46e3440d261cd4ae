"""The port's MoE (``repro_torch.models.moe``) and the MoE transformer
(grok-1 and llama4-maverick at their ``make_smoke`` widths) against the
JAX package on the CPU.

Both packages get the same numpy arrays from a seed; the port runs its
plain PyTorch path. ``moe_block``: the output, the load-balance loss and
the gradients of x, the router and the expert weights within 1e-5 of the
largest entry, top-1 and top-2, GLU and plain, with and without tokens
over capacity, and a forced tie (a zero router) routed to experts 0 … k−1
in both. The transformer: ``forward_train``'s loss and every leaf's
gradient with and without the KV term (llama4's dense/MoE interleave
included), the ``moe_chunk`` path, and prefill plus three greedy decode
tokens on a dense and a PQ cache (tokens equal, logits within 1e-5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.kv_quant import KVQuantConfig as JKVQuantConfig
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import configs, convert
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt_lib

MOE_ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
REL = 1e-5


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


def _close(got, want, rel: float = REL, what: str = "") -> None:
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


# -- moe_block ----------------------------------------------------------------


def _block_inputs(T=40, d=16, f=24, E=4, glu=True, zero_router=False,
                  seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    r = (np.zeros((d, E), np.float32) if zero_router
         else rng.standard_normal((d, E)).astype(np.float32))
    wi = (0.2 * rng.standard_normal((E, d, f))).astype(np.float32)
    wg = (0.2 * rng.standard_normal((E, d, f))).astype(np.float32) \
        if glu else None
    wo = (0.2 * rng.standard_normal((E, f, d))).astype(np.float32)
    return x, r, wi, wg, wo


def _both_blocks(args, E, k, factor, activation="gelu"):
    """(JAX out, aux, grads) and (port out, aux, grads) of
    sum(out²) + aux, the grads of every operand given (wg when not
    None)."""
    jcfg = jmoe.MoEConfig(E, k, factor)
    tcfg = moe.MoEConfig(E, k, factor)
    idx = [i for i, a in enumerate(args) if a is not None]

    def jf(*ops):
        full = list(args)
        for i, a in zip(idx, ops):
            full[i] = a
        out, aux = jmoe.moe_block(*full, jcfg, activation=activation,
                                  rule_table={})
        return jnp.sum(out * out) + aux, (out, aux)

    (_, (jo, ja)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(idx))), has_aux=True))(
            *[jnp.asarray(args[i]) for i in idx])
    ts = [None if a is None else _t(a).requires_grad_(True) for a in args]
    out, aux = moe.moe_block(*ts, tcfg, activation=activation)
    grads = torch.autograd.grad((out * out).sum() + aux,
                                [ts[i] for i in idx])
    return (jo, ja, jg), (out, aux, grads), tcfg


@pytest.mark.parametrize("factor", [4.0, 0.5], ids=["no_overflow", "drops"])
@pytest.mark.parametrize("glu", [True, False], ids=["glu", "plain"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_block_matches_jax(k, glu, factor):
    """Output, aux and the gradients of x, router, wi, (wg,) wo within
    1e-5 of the largest entry; at factor 4 (C ≥ T) nothing drops, at 0.5
    tokens drop in both (the outputs agree only if the same entries
    drop). At top-1 the renormalised gate is g/g, whose derivative is 0
    in exact arithmetic: the router's gradient of the output term is then
    the float32 residual of 1/g − g/g², summed in each package's order,
    so there the router is held to 1e-5 on the load-balance loss alone
    (the exact part) and to 1e-4 on the whole loss."""
    E, T = 4, 40
    args = _block_inputs(T=T, E=E, glu=glu)
    (jo, ja, jg), (out, aux, grads), tcfg = _both_blocks(args, E, k, factor)
    _close(out, jo, what="out")
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    assert abs(float(aux) - float(ja)) <= REL * abs(float(ja))
    names = [n for n, a in zip(("x", "router", "wi", "wg", "wo"), args)
             if a is not None]
    for name, g, want in zip(names, grads, jg):
        _close(g, want, rel=1e-4 if (name, k) == ("router", 1) else REL,
               what=name)
    if k == 1:
        x, r0, wi, wg, wo = args
        jr = jax.grad(lambda r: jmoe.moe_block(
            x, r, wi, wg, wo, jmoe.MoEConfig(E, k, factor),
            activation="gelu", rule_table={})[1])(jnp.asarray(r0))
        r = _t(r0).requires_grad_(True)
        aux_r = moe.moe_block(_t(x), r, _t(wi), None if wg is None
                              else _t(wg), _t(wo), tcfg,
                              activation="gelu")[1]
        _close(torch.autograd.grad(aux_r, r)[0], jr, what="router, aux")
    ids = moe.route(_t(args[0]), _t(args[1]), tcfg)[2]
    dropped = int(moe.dropped(ids, tcfg, T))
    assert (dropped > 0) == (factor < 1), dropped


@pytest.mark.parametrize("k", [1, 2])
def test_moe_router_tie_goes_to_the_lowest_experts(k):
    """A zero router makes every probability 1/E: both packages route
    every token to experts 0 … k−1, the ids bit-equal to lax.top_k's
    (torch.topk orders this tie otherwise), and the over-capacity
    entries drop alike."""
    E, T = 4, 40
    args = _block_inputs(T=T, E=E, zero_router=True, seed=1)
    tcfg = moe.MoEConfig(E, k)
    _, gates, ids = moe.route(_t(args[0]), _t(args[1]), tcfg)
    probs = jax.nn.softmax(jnp.asarray(args[0]) @ jnp.asarray(args[1]), -1)
    jgates, jids = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids == torch.arange(k)).all()
    np.testing.assert_array_equal(gates.numpy(), np.asarray(
        jgates / jnp.maximum(jnp.sum(jgates, -1, keepdims=True), 1e-9)))
    assert int(moe.dropped(ids, tcfg, T)) == T * k - k * moe.capacity(T,
                                                                     tcfg)
    (jo, ja, _), (out, aux, _), _ = _both_blocks(args, E, k, 1.25)
    _close(out, jo, what="out")
    assert abs(float(aux) - float(ja)) <= REL * abs(float(ja))


def test_capacity_matches_jax():
    for T in (1, 7, 8, 64, 100, 4096, 32768):
        for k in (1, 2):
            for E in (4, 8, 128):
                for factor in (0.5, 1.0, 1.25, 2.0):
                    got = moe.capacity(T, moe.MoEConfig(E, k, factor))
                    assert got == jmoe.capacity(T, jmoe.MoEConfig(E, k,
                                                                  factor))
                    assert got >= 8 and got % 8 == 0


# -- the MoE transformer ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, kvq: bool):
    """The JAX smoke params of ``arch`` (with the kvq leaves of
    KVQuantConfig(hd, 4, 16) when ``kvq``), made once a file: the eager
    init takes seconds."""
    jcfg = jconfigs.get(arch).make_smoke()
    if kvq:
        jcfg = jcfg._replace(kv_quant=JKVQuantConfig(jcfg.head_dim, 4, 16))
    return jtfm.init_params(jax.random.PRNGKey(0), jcfg)


def _pair(arch: str, kvq: bool, moe_chunk: int = 0, train_kv: bool = True):
    """The JAX smoke config and params, and the port's, the leaves carried
    across by convert; kvq adds KVQuantConfig(hd, 4, 16), with
    train_kv_quant unless ``train_kv`` is False."""
    jcfg = jconfigs.get(arch).make_smoke()._replace(moe_chunk=moe_chunk)
    cfg = configs.get(arch).make_smoke()._replace(moe_chunk=moe_chunk)
    if kvq:
        hd = cfg.head_dim
        jcfg = jcfg._replace(kv_quant=JKVQuantConfig(hd, 4, 16),
                             train_kv_quant=train_kv)
        cfg = cfg._replace(kv_quant=KVQuantConfig(hd, 4, 16),
                           train_kv_quant=train_kv)
    jp = _jax_params(arch, kvq)
    p = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")
    for leaf in opt_lib.named_leaves(p).values():
        leaf.requires_grad_(True)
    return jcfg, jp, cfg, p


def _train_both(jcfg, jp, cfg, p, B=2, S=32):
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda pp: jtfm.forward_train(
        pp, jnp.asarray(tok), jnp.asarray(lab), jcfg)))(jp)
    leaves = opt_lib.named_leaves(p)
    loss = tfm.forward_train(p, _t(tok), _t(lab), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(jl), _flat(jg)), (loss, dict(zip(leaves, grads)))


@pytest.mark.parametrize("kvq", [False, True], ids=["dense_kv", "kvq"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_train_loss_and_grads_match_jax(arch, kvq):
    """The loss (1e-5 relative) and every leaf's gradient (1e-5 of its
    largest entry) against JAX's, the spec trees equal (llama4's
    ``layers/a`` dense and ``layers/b`` MoE stacks of L/2); with the KV
    term each of the L kvq rows gets a gradient (row 2j + i for sublayer i
    of block j)."""
    jcfg, jp, cfg, p = _pair(arch, kvq)
    specs = _flat(tfm.param_specs(cfg))
    jspecs = _flat(jtfm.param_specs(jcfg))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in jspecs.items()}
    if cfg.interleaved:
        L2 = cfg.num_layers // 2
        assert specs["layers/a/ffn/wi"].shape == (L2, cfg.d_model, cfg.d_ff)
        assert specs["layers/b/ffn/wi"].shape == (
            L2, cfg.moe.num_experts, cfg.d_model, cfg.d_ff)
        assert "router" not in p["layers"]["a"]["ffn"]
    (jl, jg), (loss, grads) = _train_both(jcfg, jp, cfg, p)
    assert set(grads) == set(jg)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - jl) <= REL * abs(jl)
    for k, g in grads.items():
        _close(g, jg[k], what=k)
    if kvq:
        for k in ("kvq/rot_k", "kvq/cb_v"):
            per_row = grads[k].reshape(cfg.num_layers, -1).abs().amax(1)
            assert bool((per_row > 0).all()), k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_chunk_path_matches_jax(arch):
    """moe_chunk = 16 splits each MoE layer's 64 tokens into 4 chunks (the
    capacity of a chunk's own T, aux the chunks' mean) in forward_train and
    serve_prefill, as JAX's lax.map does; the loss differs from the
    unchunked one; a ragged chunk raises."""
    jcfg, jp, cfg, p = _pair(arch, False, moe_chunk=16)
    (jl, jg), (loss, grads) = _train_both(jcfg, jp, cfg, p)
    assert abs(float(loss) - jl) <= REL * abs(jl)
    for k, g in grads.items():
        _close(g, jg[k], what=k)
    whole = tfm.forward_train(p, *[_t(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))] * 2, cfg._replace(moe_chunk=0))
    assert float(whole) != float(loss)
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    jlog, _ = jax.jit(jtfm.serve_prefill, static_argnums=(2,))(
        jp, jnp.asarray(tok, jnp.int32), jcfg)
    with torch.no_grad():
        logits, _ = tfm.serve_prefill(p, _t(tok), cfg)
    _close(logits, jlog, what="prefill logits")
    with pytest.raises(ValueError, match="moe_chunk"):
        tfm.forward_train(p, _t(tok[:, :12]), _t(tok[:, :12]),
                          cfg._replace(moe_chunk=10))


@pytest.mark.parametrize("pq", [False, True], ids=["dense", "pq"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_greedy_decode_match_jax(arch, pq):
    """serve_prefill then three greedy serve_decode tokens in both
    packages from the same carried leaves: the greedy tokens equal, every
    step's logits within 1e-5 of the largest, the PQ codes equal."""
    jcfg, jp, cfg, p = _pair(arch, pq, train_kv=False)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    prefill = jax.jit(jtfm.serve_prefill, static_argnums=(2, 3))
    decode = jax.jit(jtfm.serve_decode, static_argnums=(3,))
    jlog, jcache = prefill(jp, jnp.asarray(tok, jnp.int32), jcfg, 16)
    with torch.no_grad():
        logits, cache = tfm.serve_prefill(p, _t(tok), cfg, max_len=16)
        _close(logits, jlog, what="prefill")
        for step in range(3):
            jnext = jnp.argmax(jlog, -1).astype(jnp.int32)
            nxt = logits.argmax(-1)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
            jlog, jcache = decode(jp, jnext, jcache, jcfg)
            logits, cache = tfm.serve_decode(p, nxt, cache, cfg)
            _close(logits, jlog, what=f"decode {step}")
    if pq:
        np.testing.assert_array_equal(cache.k_codes.numpy(),
                                      np.asarray(jcache.k_codes))
        np.testing.assert_array_equal(cache.v_codes.numpy(),
                                      np.asarray(jcache.v_codes))
    assert int(cache.length[0]) == 15
