"""Transformer layer primitives for serving (port of the serving part of
``repro/models/layers.py``): norms, activations, RoPE, attention.

Plain PyTorch matmuls, as the reference is plain JAX, with its masking and
dtype steps kept so the two agree: statistics and softmax in float32, the
result in the model dtype. ``scaled_dot_product_attention`` is not used.
Prefill attention runs over query chunks so the (B, H, S, S) score tensor is
never held at once. ``softmax_xent_chunked`` belongs to LM training, a later
slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked rows finite


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) · scale: float32 statistics, applied in x's dtype."""
    d = x.shape[-1]
    ss = torch.sum(torch.square(x.float()), dim=-1, keepdim=True) / d
    out = x * torch.rsqrt(ss + eps).to(x.dtype)
    if scale is not None:
        out = out * scale.to(x.dtype)
    return out


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's LayerNorm without scale or bias: float32 statistics, applied
    in x's dtype."""
    d = x.shape[-1]
    xf = x.float()
    mu = torch.sum(xf, dim=-1, keepdim=True) / d
    ss = torch.sum(torch.square(xf), dim=-1, keepdim=True) / d
    var = torch.clamp(ss - torch.square(mu), min=0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mu.to(x.dtype)) * inv.to(x.dtype)


def apply_norm(x: torch.Tensor, scale: torch.Tensor | None,
               kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, scale)
    if kind == "layernorm_nonparam":
        return nonparam_layer_norm(x)
    raise ValueError(f"unknown norm {kind!r}")


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":  # jax.nn.gelu is the tanh approximation
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":  # squared ReLU (Nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S): rotary embedding on split halves
    (not interleaved pairs), angles in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_chunk: int = 256,
                        causal: bool = True) -> torch.Tensor:
    """Causal GQA attention over query chunks with a float32 softmax.
    q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's dtype.
    Masked scores are NEG_INF. The peak temporary is one
    (B, Hkv, rep, q_chunk, S) float32 score tile."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"seq {S} must be divisible by q_chunk {q_chunk}")
    qg = q.reshape(B, S, Hkv, rep, hd).permute(0, 2, 3, 1, 4)  # B,Hkv,rep,S,hd
    kg = k.permute(0, 2, 1, 3).float()                         # B,Hkv,S,hd
    vg = v.permute(0, 2, 1, 3).float()
    kv_pos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, q_chunk):
        qc = qg[:, :, :, c0:c0 + q_chunk].float()
        scores = torch.einsum("bhrqd,bhsd->bhrqs", qc, kg) * scale
        if causal:
            q_pos = c0 + torch.arange(q_chunk, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhrqs,bhsd->bhrqd", w, vg).to(q.dtype))
    out = torch.cat(outs, dim=3)                               # B,Hkv,rep,S,hd
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """One decode step over a dense cache. q (B, Hq, hd), k/v_cache
    (B, Hkv, S, hd), length (B,) valid prefix (the new token already
    written); positions ≥ length score NEG_INF. Returns (B, Hq, hd) in
    q's dtype."""
    B, Hq, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, Hkv, rep, hd).float()
    scores = torch.einsum("bhrd,bhsd->bhrs", qg, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < length[:, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrs,bhsd->bhrd", w, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
