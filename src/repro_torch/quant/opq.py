"""OPQ — Optimized Product Quantization (Ge et al. 2013), port of
``repro/quant/opq.py:33-128``.

The loop alternates (a) a k-means refresh of the codebooks on the rotated
data XR and (b) a rotation update. The port runs (b) as the closed-form
Procrustes solve (``rotation="procrustes"``, classic OPQ) or not at all
(``"frozen"``, the control); the gradient learners of the JAX harness wait
for a later slice. ``index_layer.warm_start`` calls ``fit``.
"""
from __future__ import annotations

import torch

from repro_torch.quant import codebook as cb
from repro_torch.quant import kmeans as km
from repro_torch.quant.base import PQConfig
from repro_torch.quant.pq import PQ
from repro_torch.rotations.procrustes import procrustes_rotation

ROTATIONS = ("procrustes", "frozen")


def alternating_minimization(generator: torch.Generator, X: torch.Tensor,
                             cfg: PQConfig, iters: int = 30,
                             rotation: str = "procrustes",
                             kmeans_iters: int = 1):
    """Fixed-embedding rotation learning (paper §3.1). Returns
    (R (n, n), codebooks (D, K, sub), distortion trace (iters,)).

    Codebooks start from ``kmeans_iters`` Lloyd iterations on X (R = I);
    each outer iteration refreshes them with ``kmeans_iters`` more on XR,
    then solves R ← argmin ‖XR − φ(XR)‖_F (procrustes) or keeps it
    (frozen), and records the distortion of the new XR."""
    if rotation not in ROTATIONS:
        raise NotImplementedError(
            f"OPQ rotation {rotation!r} is not ported yet (ROADMAP.md queue "
            f"1, item 7); the port has {ROTATIONS}")
    n = X.shape[-1]
    R = torch.eye(n, dtype=X.dtype, device=X.device)
    codebooks, _ = km.kmeans(generator, X, cfg, iters=kmeans_iters)
    trace = []
    for _ in range(iters):
        XR = X @ R
        for _i in range(kmeans_iters):
            codebooks, _codes = km.kmeans_update(XR, codebooks)
        if rotation == "procrustes":
            target = cb.decode(cb.assign(XR, codebooks), codebooks)
            R = procrustes_rotation(X, target)
        trace.append(cb.distortion(X @ R, codebooks))
    return R, codebooks, (torch.stack(trace) if trace
                          else torch.zeros((0,), device=X.device))


def fit(generator: torch.Generator, X: torch.Tensor, cfg: PQConfig, *,
        iters: int = 30, rotation: str = "procrustes",
        kmeans_iters: int = 1) -> tuple[torch.Tensor, PQ, torch.Tensor]:
    """Protocol-idiom entry point: (R, PQ, distortion trace)."""
    R, codebooks, trace = alternating_minimization(
        generator, X, cfg, iters=iters, rotation=rotation,
        kmeans_iters=kmeans_iters)
    return R, PQ(codebooks), trace
