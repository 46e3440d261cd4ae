"""Codebook primitives shared by the quantizers (port of
``repro/quant/codebook.py``).

Codebooks are (D, K, sub) float tensors; codes are (m, D) integers (int32
from ``assign``, uint8 in index storage). ``assign`` goes through the pq_assign
kernel on the card; on the CPU its plain version works through the rows in
chunks, so encoding a million rows never holds more than a bounded
(rows, D, K) score slab.
"""
from __future__ import annotations

import torch

from repro_torch.core import givens
from repro_torch.kernels import ops as kops

#: Elements of the (rows, D, K) score slab ``assign`` holds at once.
ASSIGN_SLAB = 1 << 27


def split(X: torch.Tensor, D: int) -> torch.Tensor:
    """(..., n) -> (..., D, n/D)."""
    *lead, n = X.shape
    if n % D:
        raise ValueError(f"n={n} not divisible by D={D}")
    return X.reshape(*lead, D, n // D)


def merge(Xs: torch.Tensor) -> torch.Tensor:
    """(..., D, sub) -> (..., D*sub)."""
    *lead, D, sub = Xs.shape
    return Xs.reshape(*lead, D * sub)


def assign(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace, (m, n) -> (m, D) int32: the argmin
    over k of ‖C[d,k]‖² − 2⟨x_d, C[d,k]⟩ (ties to the first index), through
    ``kernels.ops.pq_assign``. On the card one kernel launch covers every
    row; on the CPU the plain version runs in row chunks."""
    if X.device.type != "cpu":
        return kops.pq_assign(X.contiguous(), codebooks.contiguous())
    D, K, _ = codebooks.shape
    m = X.shape[0]
    out = torch.empty((m, D), dtype=torch.int32, device=X.device)
    step = max(1, ASSIGN_SLAB // (D * K))
    for s in range(0, m, step):
        out[s:s + step] = kops.pq_assign(X[s:s + step], codebooks)
    return out


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(m, D) codes -> (m, n) reconstruction (differentiable wrt codebooks)."""
    D = codebooks.shape[0]
    d = torch.arange(D, device=codebooks.device)[None, :]
    return merge(codebooks[d, codes.long()])


def quantize(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """φ(X): hard quantization, no gradient bridging."""
    return decode(assign(X, codebooks), codebooks)


def quantize_ste(X: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """φ(X) with the straight-through estimator: the forward value is the
    quantized X, the backward the identity wrt X; the codebooks get no
    gradient here (the distortion term trains them)."""
    with torch.no_grad():
        q = decode(assign(X, codebooks), codebooks)
    return X + (q - X.detach())


def distortion(X: torch.Tensor, codebooks: torch.Tensor,
               codes: torch.Tensor | None = None) -> torch.Tensor:
    """(1/m)‖X − φ(X)‖²_F, differentiable wrt X and the codebooks (the
    assignment carries no gradient)."""
    if codes is None:
        codes = assign(X.detach(), codebooks.detach())
    q = decode(codes, codebooks)
    return torch.mean(torch.sum(torch.square(X - q), dim=-1))


def adc_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup tables LUT[b, d, k] = ⟨q_d, C[d, k]⟩,
    (b, n) -> (b, D, K)."""
    D = codebooks.shape[0]
    return torch.einsum("bds,dks->bdk", split(q, D), codebooks)


def rotate_codebooks(codebooks: torch.Tensor, pi: torch.Tensor,
                     pj: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Absorb disjoint Givens plane rotations of the full n-dim space into
    per-subspace codebooks (..., D, K, sub). Callers zero θ for
    cross-subspace pairs, which a product codebook cannot absorb."""
    *lead, D, K, sub = codebooks.shape
    cw = codebooks.movedim(-2, -3).reshape(-1, D * sub)      # (lead·K, n)
    cw = givens.apply_pair_rotations(cw, pi, pj, theta)
    return cw.reshape(*lead, K, D, sub).movedim(-2, -3).contiguous()
