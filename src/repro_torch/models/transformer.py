"""Decoder-only transformer LM, the serving half (port of
``repro/models/transformer.py``): dense and GQA variants with a dense or a
PQ-compressed KV cache.

  serve_prefill   tokens → last-token logits + a cache of ``max_len``
                  positions (dense, or PQ codes when ``cfg.kv_quant`` is set)
  serve_decode    one token in, one token's logits out; the cache is
                  written in place

Parameters carry a leading layer axis as in the JAX package, and the layers
run as a Python loop over those stacked leaves (the JAX package scans).
The cache is updated in place: a decode step writes the new position into
the cache's own tensors and returns a cache holding those same tensors,
because a functional copy would move the whole cache (4.3 GB of codes for
olmo-1b at 524,288 positions) per token.

One departure from the reference: the compressed attention's float32
output is cast to the model dtype before it joins the residual, as the
dense path's ``layers.decode_attention`` does. The JAX package adds the
float32 output to a bf16 residual, which its layer scan rejects (a carry of
another dtype); in float32 the cast is a no-op (ROADMAP.md §3).

MoE (``models/moe.py``) and the training forward are later slices: a config
with ``moe`` raises NotImplementedError. ``rules``, ``remat``,
``scan_groups`` and the other sharding and training fields are kept for
them and not read on one card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import kv_quant
from repro_torch.models import layers, param
from repro_torch.models.param import ParamSpec

MOE_LATER = ("MoE layers (models/moe.py) are not ported yet "
             "(ROADMAP.md queue 1, slice 15)")


class TransformerConfig(NamedTuple):
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"
    use_glu: bool = True
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    moe: Any = None                  # MoE config: a later slice
    moe_every: int = 1
    kv_quant: kv_quant.KVQuantConfig | None = None
    train_kv_quant: bool = False
    dtype: Any = torch.bfloat16      # activation dtype
    param_dtype: Any = torch.bfloat16
    q_chunk: int = 256
    xent_chunk: int = 8192
    moe_chunk: int = 0
    remat: bool = True
    scan_groups: int = 1
    train_accum_steps: int = 1
    rules: str = "lm_base"           # sharding rules: unused on one card


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(MOE_LATER)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> dict:
    """The JAX package's nested spec tree (dense layers only)."""
    _dense_only(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    Hq, Hkv, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {
        "wq": ParamSpec((L, d, Hq * hd), ("layers", "w_embed", "w_heads")),
        "wk": ParamSpec((L, d, Hkv * hd), ("layers", "w_embed", "w_kv_heads")),
        "wv": ParamSpec((L, d, Hkv * hd), ("layers", "w_embed", "w_kv_heads")),
        "wo": ParamSpec((L, Hq * hd, d), ("layers", "w_heads", "w_embed")),
    }
    if cfg.qkv_bias:
        attn["bq"] = ParamSpec((L, Hq * hd), ("layers", "w_heads"),
                               init="zeros")
        attn["bk"] = ParamSpec((L, Hkv * hd), ("layers", "w_kv_heads"),
                               init="zeros")
        attn["bv"] = ParamSpec((L, Hkv * hd), ("layers", "w_kv_heads"),
                               init="zeros")
    ffn = {
        "wi": ParamSpec((L, d, f), ("layers", "w_embed", "w_mlp")),
        "wo": ParamSpec((L, f, d), ("layers", "w_mlp", "w_embed")),
    }
    if cfg.use_glu:
        ffn["wg"] = ParamSpec((L, d, f), ("layers", "w_embed", "w_mlp"))
    layer_specs = {"attn": attn, "ffn": ffn}
    if cfg.norm == "rmsnorm":
        layer_specs["ln1"] = ParamSpec((L, d), ("layers", None), init="ones")
        layer_specs["ln2"] = ParamSpec((L, d), ("layers", None), init="ones")
    specs = {
        "embed": ParamSpec((V, d), ("w_vocab", "w_embed"), scale=1.0),
        "head": ParamSpec((V, d), ("w_vocab", "w_embed")),
        "layers": layer_specs,
    }
    if cfg.norm == "rmsnorm":
        specs["ln_f"] = ParamSpec((d,), (None,), init="ones")
    if cfg.kv_quant is not None:
        kq = cfg.kv_quant
        D, K, sub = kq.num_subspaces, kq.num_codewords, kq.sub
        pq_axes = ("layers", "pq_dim", "pq_code", "pq_sub")
        specs["kvq"] = {
            "rot_k": ParamSpec((L, hd, hd), ("layers", "rot_in", "rot_out"),
                               init="eye"),
            "rot_v": ParamSpec((L, hd, hd), ("layers", "rot_in", "rot_out"),
                               init="eye"),
            "cb_k": ParamSpec((L, D, K, sub), pq_axes, scale=0.02),
            "cb_v": ParamSpec((L, D, K, sub), pq_axes, scale=0.02),
        }
    return specs


def init_params(generator: torch.Generator, cfg: TransformerConfig, *,
                device=None) -> dict:
    """Seeded parameters on ``device`` (the card by default)."""
    return param.init_params(generator, param_specs(cfg), cfg.param_dtype,
                             device=device)


def _layer(tree: dict | None, i: int) -> dict | None:
    """Layer i's slice of a stacked (nested) leaf dict."""
    if tree is None:
        return None
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _kvq_params(kvq_l: dict | None) -> kv_quant.KVQuantParams | None:
    if kvq_l is None:
        return None
    return kv_quant.KVQuantParams(rot_k=kvq_l["rot_k"], rot_v=kvq_l["rot_v"],
                                  cb_k=kvq_l["cb_k"], cb_v=kvq_l["cb_v"])


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def _qkv(lp, h, cfg: TransformerConfig, positions):
    B, S, _ = h.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = lp["attn"]
    q = h @ attn["wq"].to(h.dtype)
    k = h @ attn["wk"].to(h.dtype)
    v = h @ attn["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + attn["bq"].to(h.dtype)
        k = k + attn["bk"].to(h.dtype)
        v = v + attn["bv"].to(h.dtype)
    q = layers.apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta)
    k = layers.apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Hkv, hd)


def _ffn(lp, h, cfg: TransformerConfig):
    """Dense MLP on (..., d)."""
    ffn = lp["ffn"]
    hh = h @ ffn["wi"].to(h.dtype)
    if cfg.use_glu:
        hh = layers.activate(hh, cfg.activation) * (h @ ffn["wg"].to(h.dtype))
    else:
        hh = layers.activate(hh, cfg.activation)
    return hh @ ffn["wo"].to(h.dtype)


def _norm(lp, name, x, cfg: TransformerConfig):
    scale = lp[name] if cfg.norm == "rmsnorm" else None
    return layers.apply_norm(x, scale, cfg.norm)


def _final_norm(params, x, cfg: TransformerConfig):
    scale = params["ln_f"] if cfg.norm == "rmsnorm" else None
    return layers.apply_norm(x, scale, cfg.norm)


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["head"].float().T


# ---------------------------------------------------------------------------
# Serving: prefill + decode (dense cache or PQ-compressed cache)
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    k: torch.Tensor       # (L, B, Hkv, S, hd)
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32 — number of valid positions


class PQDecodeCache(NamedTuple):
    k_codes: torch.Tensor  # (L, B, Hkv, S, D) uint8
    v_codes: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               quantized: bool | None = None, *, device=None):
    """An empty cache of ``max_len`` positions on ``device`` (the card by
    default); PQ codes when ``quantized`` (default: ``cfg.kv_quant`` set)."""
    dev = _device.resolve(device)
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    quantized = (cfg.kv_quant is not None) if quantized is None else quantized
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quantized:
        shape = (L, batch, Hkv, max_len, cfg.kv_quant.num_subspaces)
        return PQDecodeCache(
            k_codes=torch.zeros(shape, dtype=torch.uint8, device=dev),
            v_codes=torch.zeros(shape, dtype=torch.uint8, device=dev),
            length=length)
    shape = (L, batch, Hkv, max_len, hd)
    return DecodeCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       length=length)


def _write_cache(cache_layer: torch.Tensor, new: torch.Tensor,
                 length: torch.Tensor) -> None:
    """cache (B, Hkv, S, e) ← new (B, Hkv, e) at per-batch position
    ``length``, in place."""
    b = torch.arange(cache_layer.shape[0], device=cache_layer.device)
    cache_layer[b, :, length.long()] = new.to(cache_layer.dtype)


#: A decode step's profiling hook: called with the name of each part as it
#: is enqueued (see ``serve_decode``).
Marks = Callable[[str], None] | None


def _mark(marks: Marks, name: str) -> None:
    if marks is not None:
        marks(name)


def _decode_sublayer(x, lp, cfg: TransformerConfig, pos, kvq_l, kc, vc,
                     quantized: bool, marks: Marks = None):
    """One layer of one decode step; writes this layer's cache (kc, vc) in
    place. x (B, d), pos (B,)."""
    B = x.shape[0]
    Hq, hd = cfg.num_heads, cfg.head_dim
    h = _norm(lp, "ln1", x[:, None], cfg)            # (B, 1, d)
    q, k, v = _qkv(lp, h, cfg, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    _mark(marks, "qkv")
    if quantized:
        kvp = _kvq_params(kvq_l)
        ck, cv = kv_quant.encode_kv(kvp, k, v)
        _write_cache(kc, ck, pos)
        _write_cache(vc, cv, pos)
        _mark(marks, "encode_write")
        mask = (torch.arange(kc.shape[2], device=x.device)[None]
                <= pos[:, None])
        att = kv_quant.adc_decode_attention(kvp, q, kc, vc, mask,
                                            marks=marks)
        att = att.to(q.dtype)       # the departure named in the docstring
    else:
        _write_cache(kc, k, pos)
        _write_cache(vc, v, pos)
        att = layers.decode_attention(q, kc, vc, pos + 1)
        _mark(marks, "attention")
    x = x + att.reshape(B, Hq * hd) @ lp["attn"]["wo"].to(x.dtype)
    h2 = _norm(lp, "ln2", x[:, None], cfg)
    x = x + _ffn(lp, h2, cfg)[:, 0]
    _mark(marks, "out_ffn")
    return x


def serve_decode(params, token: torch.Tensor, cache,
                 cfg: TransformerConfig, *, marks: Marks = None):
    """One decode step. token (B,) → (logits (B, V) float32, cache). The
    returned cache holds the same k/v (or code) tensors, written in place
    at ``cache.length``, and ``length + 1``. ``marks``, if given, is called
    with a name after each part of each layer ("qkv", then "encode_write",
    "lut_build", "adc_batch", "softmax", "value_hist" on a PQ cache or
    "attention" on a dense one, then "out_ffn") and after the final norm
    and logits ("head"): a profiler records a CUDA event at each."""
    _dense_only(cfg)
    quantized = isinstance(cache, PQDecodeCache)
    k_all, v_all = ((cache.k_codes, cache.v_codes) if quantized
                    else (cache.k, cache.v))
    pos = cache.length
    x = params["embed"][token.long()].to(cfg.dtype)   # (B, d)
    for i in range(cfg.num_layers):
        x = _decode_sublayer(x, _layer(params["layers"], i), cfg, pos,
                             _layer(params.get("kvq"), i), k_all[i], v_all[i],
                             quantized, marks)
    x = _final_norm(params, x[:, None], cfg)[:, 0]
    logits = _logits(params, x)
    _mark(marks, "head")
    return logits, type(cache)(k_all, v_all, cache.length + 1)


def _prefill_sublayer(x, lp, cfg: TransformerConfig, positions, kvq_l,
                      quantized: bool):
    """One layer over the prompt. Returns (x, keys, values) with the cache
    entries (B, Hkv, S, hd), or their codes (B, Hkv, S, D)."""
    B, S = x.shape[:2]
    h = _norm(lp, "ln1", x, cfg)
    q, k, v = _qkv(lp, h, cfg, positions)
    att = layers.blockwise_attention(q, k, v, q_chunk=cfg.q_chunk)
    att = att.reshape(B, S, cfg.num_heads * cfg.head_dim)
    x = x + att @ lp["attn"]["wo"].to(x.dtype)
    x = x + _ffn(lp, _norm(lp, "ln2", x, cfg), cfg)
    kt = k.transpose(1, 2)                            # (B, Hkv, S, hd)
    vt = v.transpose(1, 2)
    if quantized:
        return (x, *kv_quant.encode_kv(_kvq_params(kvq_l), kt, vt))
    return x, kt, vt


def serve_prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
                  max_len: int | None = None):
    """tokens (B, S) → (last-token logits (B, V) float32, a cache of
    ``max_len`` positions, S of them written). The cache is allocated once
    and each layer writes its prompt positions into it."""
    _dense_only(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    dev = tokens.device
    quantized = cfg.kv_quant is not None
    cache = init_cache(cfg, B, max_len, device=dev)
    k_all, v_all = ((cache.k_codes, cache.v_codes) if quantized
                    else (cache.k, cache.v))
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    for i in range(cfg.num_layers):
        x, ks, vs = _prefill_sublayer(x, _layer(params["layers"], i), cfg,
                                      positions, _layer(params.get("kvq"), i),
                                      quantized)
        k_all[i, :, :, :S] = ks
        v_all[i, :, :, :S] = vs
    x = _final_norm(params, x, cfg)
    logits = _logits(params, x[:, -1])
    length = torch.full((B,), S, dtype=torch.int32, device=dev)
    return logits, type(cache)(k_all, v_all, length)


def model_flops_per_token(cfg: TransformerConfig) -> float:
    """6·N_active, the model-FLOPs numerator per token."""
    _dense_only(cfg)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * (Hq + 2 * Hkv) * hd + Hq * hd * d
    n_mats = 3 if cfg.use_glu else 2
    return 6.0 * (L * attn + L * n_mats * d * f + cfg.vocab_size * d)


def num_params(cfg: TransformerConfig) -> int:
    return param.count_params(param_specs(cfg))
