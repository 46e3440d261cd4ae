"""Transformer layer primitives (port of ``repro/models/layers.py``):
norms, activations, RoPE, attention and the chunked cross-entropy.

Plain PyTorch matmuls, as the reference is plain JAX, with its masking and
dtype steps kept so the two agree: statistics and softmax in float32, the
result in the model dtype. ``scaled_dot_product_attention`` is not used.
Training and prefill attention run over query chunks so the (B, H, S, S)
score tensor is never held at once; when autograd records, each chunk is
recomputed in the backward (``torch.utils.checkpoint``, as the JAX package
checkpoints each chunk), so the backward holds one chunk's scores at a
time too. ``softmax_xent_chunked`` does the same over token chunks of the
(T, V) logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

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


def _records(*tensors: torch.Tensor) -> bool:
    """True where autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attend_chunk(qc: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                  c0: int, scale: float, causal: bool) -> torch.Tensor:
    """One query chunk qc (B, Hkv, rep, c, hd) against all keys kg/vg
    (B, Hkv, S, hd) float32; the output in qc's dtype."""
    q_chunk, S = qc.shape[3], kg.shape[2]
    scores = torch.einsum("bhrqd,bhsd->bhrqs", qc.float(), kg) * scale
    if causal:
        q_pos = c0 + torch.arange(q_chunk, device=qc.device)
        kv_pos = torch.arange(S, device=qc.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhrqs,bhsd->bhrqd", w, vg).to(qc.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_chunk: int = 256,
                        causal: bool = True) -> torch.Tensor:
    """Causal GQA attention over query chunks with a float32 softmax.
    q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's dtype.
    Masked scores are NEG_INF. The peak temporary is one
    (B, Hkv, rep, q_chunk, S) float32 score tile, in the forward and, when
    autograd records, in the backward: each chunk is then recomputed
    there (``torch.utils.checkpoint``), not kept, so the backward does not
    hold every chunk's float32 softmax (B·H·S²·4 bytes a layer)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"seq {S} must be divisible by q_chunk {q_chunk}")
    recompute = _records(q, k, v)
    qg = q.reshape(B, S, Hkv, rep, hd).permute(0, 2, 3, 1, 4)  # B,Hkv,rep,S,hd
    kg = k.permute(0, 2, 1, 3).float()                         # B,Hkv,S,hd
    vg = v.permute(0, 2, 1, 3).float()
    outs = []
    for c0 in range(0, S, q_chunk):
        qc = qg[:, :, :, c0:c0 + q_chunk]
        if recompute:
            outs.append(_ckpt.checkpoint(
                _attend_chunk, qc, kg, vg, c0, scale, causal,
                use_reentrant=False, preserve_rng_state=False))
        else:
            outs.append(_attend_chunk(qc, kg, vg, c0, scale, causal))
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


def _xent_chunk(xi: torch.Tensor, head: torch.Tensor,
                li: torch.Tensor) -> torch.Tensor:
    """Σ over a chunk's tokens of logsumexp − the gold logit. The logits'
    product runs in the operands' dtype and is cast to float32 after it,
    as the JAX package does."""
    dt = torch.promote_types(xi.dtype, head.dtype)
    logits = (xi.to(dt) @ head.to(dt).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, li[:, None].long())[:, 0]
    return torch.sum(lse - gold)


def softmax_xent_chunked(x: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, *,
                         chunk: int = 8192) -> torch.Tensor:
    """Mean cross-entropy of x (T, d) under logits x·headᵀ (head (V, d))
    against labels (T,), without holding all (T, V) logits at once: the
    sum over token chunks of logsumexp − gold logit, divided by T, float32.
    When autograd records, each chunk's logits are recomputed in the
    backward (``torch.utils.checkpoint``), so the peak is O(chunk · V).
    ``T % min(chunk, T)`` must be 0."""
    T, _ = x.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"tokens {T} must be divisible by chunk {chunk}")
    recompute = _records(x, head)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        xi, li = x[c0:c0 + chunk], labels[c0:c0 + chunk]
        if recompute:
            part = _ckpt.checkpoint(_xent_chunk, xi, head, li,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            part = _xent_chunk(xi, head, li)
        total = total + part
    return total / T
