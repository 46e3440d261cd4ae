"""PQ-compressed KV cache with a per-layer rotation (port of
``repro/core/kv_quant.py``): the paper's embedding-index layer T(X) =
φ(XR)Rᵀ carried over to attention keys and values.

Keys and values are quantized per head vector with a rotation
R ∈ SO(head_dim) and codebooks per layer; each of keys and values is a
``quant.PQ`` over the ``cb_k``/``cb_v`` leaves. Decode-time attention never
dequantizes the cache:

  * scores:  q·k̂ᵀ = Σ_d LUT[d, code_d] with LUT = adc_tables(qR), through
             the grouped ADC kernel (``kernels.ops.adc_batch``; one
             (batch, kv-head) pair per group, the GQA rep queries of the
             group share its codes);
  * output:  Σ_s w_s·v̂_s = Σ_{d,k} H[d,k]·C_v[d,k] with the weight
             histogram H[d,k] = Σ_{s: code_s,d = k} w_s (``scatter_add_``
             and a small einsum, plain PyTorch as in the JAX package).

Where the JAX package works in the model dtype, this port rotates and
builds the tables in float32: ``pq_assign`` and ``adc_batch`` take float32
operands on the card. In float32 the two agree; in bf16 the JAX package's
argmin may break ties differently (ROADMAP.md, parity hazards).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch import quant
from repro_torch.kernels import ops as kops

#: Code rows of the value histogram widened to int64 at once: the scatter
#: needs int64 indices, and widening a whole 524,288-position layer would
#: be a 1 GB temporary per step.
HIST_ROWS = 1 << 16


class KVQuantConfig(NamedTuple):
    head_dim: int
    num_subspaces: int = 16
    num_codewords: int = 256

    @property
    def sub(self) -> int:
        return self.head_dim // self.num_subspaces

    @property
    def pq_cfg(self) -> quant.PQConfig:
        return quant.PQConfig(self.num_subspaces, self.num_codewords)


class KVQuantParams(NamedTuple):
    """Per-layer parameters (no leading layer axis). ``quant_k``/``quant_v``
    view the codebooks as float32 quantizers."""

    rot_k: torch.Tensor  # (hd, hd)
    rot_v: torch.Tensor  # (hd, hd)
    cb_k: torch.Tensor   # (D, K, sub)
    cb_v: torch.Tensor   # (D, K, sub)

    @property
    def quant_k(self) -> quant.PQ:
        return quant.PQ(self.cb_k.float())

    @property
    def quant_v(self) -> quant.PQ:
        return quant.PQ(self.cb_v.float())


def init(generator: torch.Generator, cfg: KVQuantConfig,
         dtype=torch.float32, *, device=None) -> KVQuantParams:
    """Identity rotations and 0.02-scale normal codebooks on ``device``
    (the card by default)."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    hd, D, K, sub = cfg.head_dim, cfg.num_subspaces, cfg.num_codewords, cfg.sub

    def normal():
        return (0.02 * torch.randn((D, K, sub), generator=generator,
                                   device=dev)).to(dtype)

    eye = torch.eye(hd, dtype=dtype, device=dev)
    return KVQuantParams(rot_k=eye, rot_v=eye.clone(), cb_k=normal(),
                         cb_v=normal())


def _flatten_heads(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """(..., hd) -> (prod(...), hd) plus the lead shape for unflattening."""
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def encode_kv(params: KVQuantParams, k: torch.Tensor, v: torch.Tensor):
    """Quantize key/value tensors (..., hd) -> codes (..., D) uint8 (int32
    past 256 codewords), rotated and assigned in float32."""
    qk, qv = params.quant_k, params.quant_v
    kf, lead = _flatten_heads(k)
    vf, _ = _flatten_heads(v)
    ck = qk.encode(kf.float() @ params.rot_k.float()).to(qk.code_dtype)
    cv = qv.encode(vf.float() @ params.rot_v.float()).to(qv.code_dtype)
    return (ck.reshape(*lead, qk.code_width),
            cv.reshape(*lead, qv.code_width))


def decode_k(params: KVQuantParams, codes: torch.Tensor) -> torch.Tensor:
    """Codes (..., D) -> dense keys (..., hd) float32: k̂ = decode(c)·Rᵀ."""
    lead = codes.shape[:-1]
    flat = params.quant_k.decode(codes.reshape(-1, codes.shape[-1]))
    rot = params.rot_k.float()
    return (flat @ rot.T).reshape(*lead, rot.shape[0])


def decode_v(params: KVQuantParams, codes: torch.Tensor) -> torch.Tensor:
    lead = codes.shape[:-1]
    flat = params.quant_v.decode(codes.reshape(-1, codes.shape[-1]))
    rot = params.rot_v.float()
    return (flat @ rot.T).reshape(*lead, rot.shape[0])


def _mark(marks: Callable[[str], None] | None, name: str) -> None:
    if marks is not None:
        marks(name)


def adc_scores_grouped(params: KVQuantParams, q: torch.Tensor,
                       k_codes: torch.Tensor,
                       marks: Callable[[str], None] | None = None
                       ) -> torch.Tensor:
    """Grouped ADC scoring, the decode hot path. q (g, r, hd) queries vs
    k_codes (g, S, D): group g is one (batch, kv-head) pair, r its GQA
    query repetition. One (r, D, K) float32 table per group, then
    ``kernels.ops.adc_batch`` (the kernel for CUDA tensors, its plain
    version for CPU ones); the codes are never broadcast over r.
    ``marks``, if given, is called after the table build ("lut_build")
    and after the scan ("adc_batch"). Returns (g, r, S) float32."""
    g, r, hd = q.shape
    qr = q.float() @ params.rot_k.float()
    lut = params.quant_k.adc_tables(qr.reshape(g * r, hd))
    lut = lut.reshape(g, r, *lut.shape[1:]).contiguous()   # (g, r, D, K)
    _mark(marks, "lut_build")
    scores = kops.adc_batch(lut, k_codes.contiguous())
    _mark(marks, "adc_batch")
    return scores


def adc_scores(params: KVQuantParams, q: torch.Tensor,
               k_codes: torch.Tensor) -> torch.Tensor:
    """q (..., hd) vs key codes (..., S, D) -> scores (..., S). Leading
    axes broadcast; each joint lead element is one single-query group of
    the grouped scorer (a size-1 broadcast axis copies codes here — the
    GQA decode path calls ``adc_scores_grouped`` to share them)."""
    hd = q.shape[-1]
    S, D = k_codes.shape[-2:]
    lead = torch.broadcast_shapes(q.shape[:-1], k_codes.shape[:-2])
    qb = q.expand(*lead, hd).reshape(-1, 1, hd)
    cb = k_codes.expand(*lead, S, D).reshape(-1, S, D)
    return adc_scores_grouped(params, qb, cb).reshape(*lead, S)


def weighted_value_sum(params: KVQuantParams, w: torch.Tensor,
                       v_codes: torch.Tensor) -> torch.Tensor:
    """Σ_s w[..., s] · v̂[..., s, :] without dequantizing the cache.

    H[..., d, k] = Σ_{s: code=k} w_s (a ``scatter_add_`` into (D, K) bins
    per (group, rep)), out = Σ_{d,k} H·C_v[d,k] concatenated over d, rotated
    back. w (..., S), v_codes (..., S, D) with w's extra lead axes (the GQA
    rep) sharing one set of codes -> (..., hd) float32. The codes are
    widened to int64 HIST_ROWS rows at a time and never broadcast over the
    rep axis. On the card the scatter adds in no fixed order."""
    D, K, sub = params.cb_v.shape
    S = w.shape[-1]
    lead = tuple(w.shape[:-1])
    code_lead = tuple(v_codes.shape[:-2])
    G = 1
    for n in code_lead:
        G *= n
    R = 1
    for n in lead[len(code_lead):]:
        R *= n
    wf = w.float().reshape(G, R, S)
    cf = v_codes.reshape(G, S, D)
    hist = torch.zeros((G, R, D, K), dtype=torch.float32, device=w.device)
    for s0 in range(0, S, HIST_ROWS):
        idx = cf[:, s0:s0 + HIST_ROWS].permute(0, 2, 1).long()   # (G, D, s)
        for j in range(R):
            src = wf[:, j, None, s0:s0 + HIST_ROWS].expand(idx.shape)
            hist[:, j].scatter_add_(2, idx, src)
    parts = torch.einsum("gjdk,dks->gjds", hist, params.cb_v.float())
    out = parts.reshape(G, R, D * sub) @ params.rot_v.float().T
    return out.reshape(*lead, D * sub)


def adc_decode_attention(params: KVQuantParams, q: torch.Tensor,
                         k_codes: torch.Tensor, v_codes: torch.Tensor,
                         length_mask: torch.Tensor | None = None,
                         scale: float | None = None,
                         marks: Callable[[str], None] | None = None
                         ) -> torch.Tensor:
    """One decode step of attention in the compressed domain. q (B, H, hd),
    k_codes/v_codes (B, H_kv, S, D), length_mask (B, S) bool (True =
    valid; masked scores are −inf). GQA: H % H_kv == 0. ``marks``, if
    given, is called after each part: "lut_build", "adc_batch", "softmax",
    "value_hist" (a profiler's CUDA events). Returns (B, H, hd) float32."""
    B, H, hd = q.shape
    H_kv, S, D = k_codes.shape[1:]
    rep = H // H_kv
    scale = (hd ** -0.5) if scale is None else scale
    scores = adc_scores_grouped(
        params, q.reshape(B * H_kv, rep, hd), k_codes.reshape(B * H_kv, S, D),
        marks).reshape(B, H_kv, rep, S) * scale
    if length_mask is not None:
        scores = scores.masked_fill(~length_mask[:, None, None, :],
                                    float("-inf"))
    w = torch.softmax(scores, dim=-1)
    _mark(marks, "softmax")
    out = weighted_value_sum(params, w, v_codes)   # (B, H_kv, rep, hd)
    _mark(marks, "value_hist")
    return out.reshape(B, H, hd)


def kv_distortion(params: KVQuantParams, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Distortion on sampled K/V vectors, the Eq. (1) second term for the KV
    index (the training slice uses it; the rotation is applied in float32
    as in ``encode_kv``)."""
    kf, _ = _flatten_heads(k)
    vf, _ = _flatten_heads(v)
    dk = params.quant_k.distortion(kf.float() @ params.rot_k.float())
    dv = params.quant_v.distortion(vf.float() @ params.rot_v.float())
    return dk + dv
