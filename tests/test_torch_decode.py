"""The port's LM decode slice (``repro_torch.core.kv_quant``,
``models.layers``, ``models.transformer``, ``configs``, the grouped ADC
scan ``adc_batch_ref``) against the JAX package on the CPU, on the same
numpy inputs, at smoke widths.

Tolerances: scores, LUT sums and kv_quant outputs within 1e-5 of the
largest entry (float32 sums in another order); codes equal; layer
functions within 1e-5; logits of prefill and three greedy decode steps
within 1e-4 of the largest logit (a float32 model of two layers, summed in
another order by XLA and PyTorch). "Relative" is to a tensor's largest
entry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import kv_quant as jkv
from repro.kernels import adc_batch as jadcb
from repro.kernels import adc_common as jadc
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import configs, convert, device
from repro_torch.core import kv_quant as kv
from repro_torch.kernels import adc_common, ops, ref
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

LM_ARCHS = ["olmo-1b", "qwen1.5-4b", "nemotron-4-340b"]
PROMPT, EXTRA, STEPS = 16, 8, 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rel: float) -> None:
    """|got − want| ≤ rel · max|want| elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


# -- adc_batch ----------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("lut_dtype", ["float32", "int8", "uint8"])
def test_adc_batch_ref_matches_jax(lut_dtype, r):
    """The plain grouped scan against the JAX Pallas kernel (interpret
    mode, S = 300 over blocks of 128 rows) and the JAX plain version;
    uint8 codes, int8/uint8 tables with their scales."""
    rng = np.random.default_rng(3 + r)
    g, Dp, K, S = 3, 8, 32, 300
    lut = rng.standard_normal((g, r, Dp, K)).astype(np.float32)
    codes = rng.integers(0, K, (g, S, Dp)).astype(np.uint8)
    scales = None
    if lut_dtype != "float32":
        jl, js = jadc.quantize_luts(jnp.asarray(lut), lut_dtype)
        lut, scales = np.asarray(jl), np.asarray(js)
    jscales = None if scales is None else jnp.asarray(scales)
    want_ref = jref.adc_batch_ref(jnp.asarray(lut), jnp.asarray(codes),
                                  jscales)
    want_kernel = jadcb.adc_batch(jnp.asarray(lut), jnp.asarray(codes),
                                  jscales, block_s=128, interpret=True)
    got = ref.adc_batch_ref(_t(lut), _t(codes),
                            None if scales is None else _t(scales))
    assert got.dtype == torch.float32 and got.shape == (g, r, S)
    _close(got, want_ref, 1e-6)
    _close(got, want_kernel, 1e-5)
    # the wrapper takes the plain version for CPU tensors and launches nothing
    before = ops.LAUNCHES["adc_batch"]
    torch.testing.assert_close(
        ops.adc_batch(_t(lut), _t(codes),
                      None if scales is None else _t(scales)), got,
        rtol=0, atol=0)
    assert ops.LAUNCHES["adc_batch"] == before


def test_adc_batch_quantized_pack_matches_port_quantizer():
    """The port's own int8/uint8 packs give the JAX package's (same
    rounding), and the plain grouped scan dequantizes them as
    dequantize_luts does."""
    rng = np.random.default_rng(11)
    lut = rng.standard_normal((2, 2, 4, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (2, 50, 4)).astype(np.uint8)
    for dt in ("int8", "uint8"):
        jl, js = jadc.quantize_luts(jnp.asarray(lut), dt)
        tl, ts = adc_common.quantize_luts(_t(lut), dt)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        _close(ts, js, 1e-7)
        deq = adc_common.dequantize_luts(tl, ts)
        want = ref.adc_batch_ref(deq, _t(codes))
        torch.testing.assert_close(ref.adc_batch_ref(tl, _t(codes), ts),
                                   want, rtol=0, atol=0)


# -- kv_quant -----------------------------------------------------------------


def _kv_setup(hd=16, D=4, K=16, B=2, Hkv=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    rot = np.linalg.qr(rng.standard_normal((2, hd, hd)))[0].astype(np.float32)
    cb = rng.standard_normal((2, D, K, hd // D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    jp = jkv.KVQuantParams(rot_k=jnp.asarray(rot[0]), rot_v=jnp.asarray(rot[1]),
                           cb_k=jnp.asarray(cb[0]), cb_v=jnp.asarray(cb[1]))
    tp = kv.KVQuantParams(rot_k=_t(rot[0]), rot_v=_t(rot[1]), cb_k=_t(cb[0]),
                          cb_v=_t(cb[1]))
    return jp, tp, k, v, rng


def test_kv_init_shapes_and_identity():
    cfg = kv.KVQuantConfig(head_dim=16, num_subspaces=4, num_codewords=16)
    p = kv.init(device.generator(0, "cpu"), cfg, device="cpu")
    jp = jkv.init(jax.random.PRNGKey(0), jkv.KVQuantConfig(16, 4, 16))
    for name in p._fields:
        assert tuple(getattr(p, name).shape) == getattr(jp, name).shape
    assert torch.equal(p.rot_k, torch.eye(16))
    assert cfg.sub == 4 and cfg.pq_cfg == (4, 16)
    assert float(p.cb_k.std()) == pytest.approx(0.02, rel=0.2)


def test_encode_decode_kv_match_jax():
    jp, tp, k, v, _ = _kv_setup()
    jck, jcv = jkv.encode_kv(jp, jnp.asarray(k), jnp.asarray(v))
    ck, cv = kv.encode_kv(tp, _t(k), _t(v))
    assert ck.dtype == torch.uint8 and ck.shape == (2, 2, 24, 4)
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jcv))
    _close(kv.decode_k(tp, ck), jkv.decode_k(jp, jck), 1e-5)
    _close(kv.decode_v(tp, cv), jkv.decode_v(jp, jcv), 1e-5)


def test_adc_scores_match_jax_and_decoded_dot():
    jp, tp, k, v, rng = _kv_setup(seed=1)
    ck, _ = kv.encode_kv(tp, _t(k), _t(v))
    q = rng.standard_normal((2, 2, 16)).astype(np.float32)
    got = kv.adc_scores(tp, _t(q), ck)
    want = jkv.adc_scores(jp, jnp.asarray(q), jnp.asarray(ck.numpy()))
    _close(got, want, 1e-5)
    dot = torch.einsum("bhd,bhsd->bhs", _t(q), kv.decode_k(tp, ck))
    _close(got, dot.numpy(), 1e-5)


def test_adc_scores_grouped_match_jax_kernel_and_ref():
    """Grouped scorer, GQA rep 3: the JAX Pallas path (interpret) and its
    plain path."""
    jp, tp, k, v, rng = _kv_setup(seed=2)
    ck, _ = kv.encode_kv(tp, _t(k), _t(v))
    codes = ck.reshape(4, 24, 4)
    q = rng.standard_normal((4, 3, 16)).astype(np.float32)
    got = kv.adc_scores_grouped(tp, _t(q), codes)
    assert got.shape == (4, 3, 24)
    jc = jnp.asarray(codes.numpy())
    for use_kernel in (False, True):
        want = jkv.adc_scores_grouped(jp, jnp.asarray(q), jc,
                                      use_kernel=use_kernel)
        _close(got, want, 1e-5)


def test_weighted_value_sum_matches_jax_gqa():
    """w carries a rep axis the codes do not; the histogram shares one set
    of codes across it. Chunked widening (HIST_ROWS) changes nothing."""
    jp, tp, k, v, rng = _kv_setup(seed=3)
    _, cv = kv.encode_kv(tp, _t(k), _t(v))
    w = rng.random((2, 2, 3, 24)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    want = jkv.weighted_value_sum(jp, jnp.asarray(w), jnp.asarray(cv.numpy()))
    got = kv.weighted_value_sum(tp, _t(w), cv)
    assert got.shape == (2, 2, 3, 16)
    _close(got, want, 1e-5)
    old = kv.HIST_ROWS
    try:
        kv.HIST_ROWS = 5
        _close(kv.weighted_value_sum(tp, _t(w), cv), want, 1e-5)
    finally:
        kv.HIST_ROWS = old


@pytest.mark.parametrize("masked", [False, True])
def test_adc_decode_attention_matches_jax(masked):
    """GQA (4 query heads over 2 kv heads) with and without a per-batch
    length mask."""
    jp, tp, k, v, rng = _kv_setup(seed=4)
    ck, cv = kv.encode_kv(tp, _t(k), _t(v))
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(24)[None] <= np.array([[9], [20]])
    jout = jkv.adc_decode_attention(
        jp, jnp.asarray(q), jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()),
        length_mask=None if mask is None else jnp.asarray(mask))
    out = kv.adc_decode_attention(tp, _t(q), ck, cv,
                                  length_mask=None if mask is None
                                  else _t(mask))
    assert out.shape == (2, 4, 16) and out.dtype == torch.float32
    _close(out, jout, 1e-5)


def test_kv_distortion_matches_jax():
    jp, tp, k, v, _ = _kv_setup(seed=5)
    want = jkv.kv_distortion(jp, jnp.asarray(k), jnp.asarray(v))
    got = kv.kv_distortion(tp, _t(k), _t(v))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# -- layers -------------------------------------------------------------------


def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(32).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    _close(layers.nonparam_layer_norm(_t(x)),
           jlayers.nonparam_layer_norm(jnp.asarray(x)), 1e-5)
    for kind, sc in (("rmsnorm", scale), ("layernorm_nonparam", None)):
        _close(layers.apply_norm(_t(x), None if sc is None else _t(sc), kind),
               jlayers.apply_norm(jnp.asarray(x), sc, kind), 1e-5)
    for kind in ("silu", "gelu", "relu2"):
        _close(layers.activate(_t(x), kind),
               jlayers.activate(jnp.asarray(x), kind), 1e-5)
    with pytest.raises(ValueError):
        layers.activate(_t(x), "tanh")


def test_rope_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    _close(layers.rope_frequencies(16, 1e6),
           jlayers.rope_frequencies(16, 1e6), 1e-6)
    for theta in (1e4, 1e6):
        _close(layers.apply_rope(_t(x), _t(pos), theta),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               1e-5)


def test_blockwise_and_decode_attention_match_jax():
    rng = np.random.default_rng(8)
    B, S, Hq, Hkv, hd = 2, 32, 4, 2, 8
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    _close(layers.blockwise_attention(_t(q), _t(k), _t(v), q_chunk=8),
           jlayers.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), q_chunk=8), 1e-5)
    kc = k.transpose(0, 2, 1, 3)
    vc = v.transpose(0, 2, 1, 3)
    length = np.array([5, 32], np.int32)
    _close(layers.decode_attention(_t(q[:, 0]), _t(kc), _t(vc), _t(length)),
           jlayers.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(length)),
           1e-5)


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_configs_match_jax(arch_id):
    spec, jspec = configs.get(arch_id), jconfigs.get(arch_id)
    assert spec.family == "lm" and set(spec.shapes) == set(jspec.shapes)
    for shape in spec.shapes:
        cfg, jcfg = spec.config_for_shape(shape), jspec.config_for_shape(shape)
        for field in tfm.TransformerConfig._fields:
            a, b = getattr(cfg, field), getattr(jcfg, field)
            if field in ("dtype", "param_dtype"):
                assert str(a).split(".")[-1] == jnp.dtype(b).name
            elif field == "kv_quant":
                assert (a is None) == (b is None) and (a is None
                                                      or tuple(a) == tuple(b))
            else:
                assert a == b, field
        if jcfg.moe is None:
            assert tfm.num_params(cfg) == jtfm.num_params(jcfg)
            assert tfm.model_flops_per_token(cfg) == pytest.approx(
                jtfm.model_flops_per_token(jcfg))


def test_config_registry():
    assert configs.get("paper-twotower").family == "recsys"
    with pytest.raises(KeyError, match="olmo-1b"):
        configs.get("grok-1-314b")
    long = configs.get("olmo-1b").config_for_shape("long_500k")
    assert long.kv_quant == kv.KVQuantConfig(128, 16, 256)
    assert configs.base.LM_SHAPES["long_500k"].params["seq_len"] == 524288
    with pytest.raises(NotImplementedError, match="MoE"):
        tfm.param_specs(long._replace(moe=object()))


# -- the serving slice --------------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(a, pq) for a in LM_ARCHS
                                        for pq in (True, False)],
                ids=lambda p: f"{p[0]}-{'pq' if p[1] else 'dense'}")
def lm_run(request):
    """JAX prefill then three greedy decode steps at smoke width; the
    outputs of every step, the JAX params and the prompt."""
    arch_id, pq = request.param
    jcfg = jconfigs.get(arch_id).make_smoke()
    if pq:
        jcfg = jcfg._replace(kv_quant=jkv.KVQuantConfig(jcfg.head_dim, 4, 16))
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    prefill = jax.jit(jtfm.serve_prefill, static_argnums=(2, 3))
    decode = jax.jit(jtfm.serve_decode, static_argnums=(3,))
    logits, cache = prefill(params, jnp.asarray(tokens), jcfg,
                            PROMPT + EXTRA)
    steps = [(np.asarray(logits), _np_tree(cache._asdict()), None)]
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode(params, tok, cache, jcfg)
        steps.append((np.asarray(logits), _np_tree(cache._asdict()),
                      np.asarray(tok)))
    tcfg = configs.get(arch_id).make_smoke()
    if pq:
        tcfg = tcfg._replace(kv_quant=kv.KVQuantConfig(tcfg.head_dim, 4, 16))
    return tcfg, _np_tree(params), tokens, steps


def _check_cache(cache, want: dict, pq: bool) -> None:
    np.testing.assert_array_equal(cache.length.numpy(), want["length"])
    if pq:
        np.testing.assert_array_equal(cache.k_codes.numpy(), want["k_codes"])
        np.testing.assert_array_equal(cache.v_codes.numpy(), want["v_codes"])
    else:
        _close(cache.k, want["k"], 1e-5)
        _close(cache.v, want["v"], 1e-5)


def test_serve_prefill_and_decode_match_jax(lm_run):
    """Prefill and three greedy decode steps, weights carried across by
    convert, each step fed the JAX step's token: logits within 1e-4 and
    caches equal (codes) or within 1e-5 (dense) after every step."""
    cfg, params_np, tokens, steps = lm_run
    pq = cfg.kv_quant is not None
    params = convert.transformer_params_from_numpy(params_np, cfg,
                                                   device="cpu")
    logits, cache = tfm.serve_prefill(params, _t(tokens), cfg,
                                      max_len=PROMPT + EXTRA)
    assert isinstance(cache, tfm.PQDecodeCache if pq else tfm.DecodeCache)
    _close(logits, steps[0][0], 1e-4)
    _check_cache(cache, steps[0][1], pq)
    for want_logits, want_cache, tok in steps[1:]:
        logits, cache = tfm.serve_decode(params, _t(tok), cache, cfg)
        _close(logits, want_logits, 1e-4)
        _check_cache(cache, want_cache, pq)


def test_decode_from_converted_jax_cache(lm_run):
    """A JAX cache carried across by convert decodes like the JAX one."""
    cfg, params_np, _, steps = lm_run
    params = convert.transformer_params_from_numpy(params_np, cfg,
                                                   device="cpu")
    cache = convert.decode_cache_from_numpy(steps[1][1], device="cpu")
    logits, cache = tfm.serve_decode(params, _t(steps[2][2]), cache, cfg)
    _close(logits, steps[2][0], 1e-4)
    _check_cache(cache, steps[2][1], cfg.kv_quant is not None)


@pytest.mark.parametrize("pq", [True, False])
def test_decode_writes_cache_in_place(pq):
    cfg = configs.get("olmo-1b").make_smoke()
    if pq:
        cfg = cfg._replace(kv_quant=kv.KVQuantConfig(16, 4, 16))
    params = tfm.init_params(device.generator(0, "cpu"), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8))
    _, cache = tfm.serve_prefill(params, tokens, cfg, max_len=12)
    before = [t.data_ptr() for t in cache[:2]]
    snapshot = [t.clone() for t in cache[:2]]
    _, new = tfm.serve_decode(params, tokens[:, -1], cache, cfg)
    assert [t.data_ptr() for t in new[:2]] == before
    assert int(new.length[0]) == 9 and int(cache.length[0]) == 8
    for t, old in zip(new[:2], snapshot):
        assert torch.equal(t[:, :, :, :8], old[:, :, :, :8])
        assert torch.equal(t[:, :, :, 9:], old[:, :, :, 9:])
        assert not torch.equal(t[:, :, :, 8], old[:, :, :, 8])


@pytest.mark.parametrize("pq", [True, False])
def test_decode_marks_each_part_and_change_nothing(pq):
    """``serve_decode``'s ``marks`` hook names each part of each layer in
    the order it runs, then the head; the step's logits and cache are the
    ones of a step without the hook."""
    cfg = configs.get("olmo-1b").make_smoke()
    if pq:
        cfg = cfg._replace(kv_quant=kv.KVQuantConfig(16, 4, 16))
    params = tfm.init_params(device.generator(0, "cpu"), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(1))
    _, c1 = tfm.serve_prefill(params, tokens, cfg, max_len=12)
    _, c2 = tfm.serve_prefill(params, tokens, cfg, max_len=12)
    names = []
    got, c1 = tfm.serve_decode(params, tokens[:, -1], c1, cfg,
                               marks=names.append)
    want, c2 = tfm.serve_decode(params, tokens[:, -1], c2, cfg)
    layer = (["qkv", "encode_write", "lut_build", "adc_batch", "softmax",
              "value_hist", "out_ffn"] if pq
             else ["qkv", "attention", "out_ffn"])
    assert names == layer * cfg.num_layers + ["head"]
    assert torch.equal(got, want)
    for a, b in zip(c1, c2):
        assert torch.equal(a, b)


def test_bf16_pq_decode_keeps_bf16_residual():
    """The departure of ROADMAP.md §3: at bf16 the JAX PQ decode fails its
    scan's carry check (float32 attention output added to a bf16
    residual); the port casts the compressed attention output to the model
    dtype, as the dense path does, and decodes."""
    jcfg = jconfigs.get("olmo-1b").make_smoke()._replace(
        kv_quant=jkv.KVQuantConfig(16, 4, 16), dtype=jnp.bfloat16,
        param_dtype=jnp.bfloat16)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(10).integers(0, 257, (1, 8)).astype(
        np.int32)
    jlogits, jcache = jtfm.serve_prefill(jparams, jnp.asarray(tokens), jcfg,
                                         max_len=12)
    with pytest.raises(TypeError, match="carry"):
        jtfm.serve_decode(jparams, jnp.argmax(jlogits, -1), jcache, jcfg)

    cfg = configs.get("olmo-1b").make_smoke()._replace(
        kv_quant=kv.KVQuantConfig(16, 4, 16), dtype=torch.bfloat16,
        param_dtype=torch.bfloat16)
    params = convert.transformer_params_from_numpy(_np_tree(jparams), cfg,
                                                   device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    logits, cache = tfm.serve_prefill(params, _t(tokens), cfg, max_len=12)
    x = params["embed"][_t(tokens[:, -1]).long()]
    out = tfm._decode_sublayer(
        x, tfm._layer(params["layers"], 0), cfg, cache.length,
        tfm._layer(params["kvq"], 0), cache.k_codes[0], cache.v_codes[0],
        True)
    assert out.dtype == torch.bfloat16
    logits, cache = tfm.serve_decode(params, logits.argmax(-1), cache, cfg)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert int(cache.length[0]) == 9


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_decode_entry_points_without_device_raise(no_gpu):
    cfg = configs.get("olmo-1b").make_smoke()
    g = device.generator(0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(g, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.init(g, kv.KVQuantConfig(16, 4, 16))
    params = tfm.init_params(g, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.transformer_params_from_numpy(
            jax.tree.map(lambda t: t.numpy(), params), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.decode_cache_from_numpy(
            {"k": np.zeros((2, 1, 4, 8, 16), np.float32),
             "v": np.zeros((2, 1, 4, 8, 16), np.float32),
             "length": np.zeros(1, np.int32)})


def test_converters_check_keys_and_shapes():
    cfg = configs.get("olmo-1b").make_smoke()._replace(
        kv_quant=kv.KVQuantConfig(16, 4, 16))
    params = tfm.init_params(device.generator(0, "cpu"), cfg, device="cpu")
    arrays = jax.tree.map(lambda t: t.numpy(), params)
    back = convert.transformer_params_from_numpy(arrays, cfg, device="cpu")
    assert torch.equal(back["kvq"]["cb_k"], params["kvq"]["cb_k"])
    assert torch.equal(back["kvq"]["rot_v"][1], torch.eye(16))
    del arrays["kvq"]["rot_k"]
    with pytest.raises(KeyError, match="rot_k"):
        convert.transformer_params_from_numpy(arrays, cfg, device="cpu")
    arrays = jax.tree.map(lambda t: t.numpy(), params)
    arrays["head"] = arrays["head"][:, :8]
    with pytest.raises(ValueError, match="head"):
        convert.transformer_params_from_numpy(arrays, cfg, device="cpu")
