"""OPQ — Optimized Product Quantization (Ge et al. 2013) and the paper's
fixed-embedding experiment harness (§3.1, Fig 2), port of
``repro/quant/opq.py:33-128``.

The loop alternates (a) a k-means refresh of the codebooks on the rotated
data XR and (b) a rotation update by any learner of the
``repro_torch.rotations`` registry: the closed-form Procrustes solve
(learners with a ``solve``, classic OPQ), the gradient learners (the GCD
family, Cayley-SGD) stepped ``inner_steps`` times on the distortion's
gradient with the codes frozen, or the frozen control. So one harness
sweeps the whole Fig 2 comparison; ``index_layer.warm_start`` calls
``fit`` with the Procrustes default.
"""
from __future__ import annotations

import torch

from repro_torch import rotations
from repro_torch.quant import codebook as cb
from repro_torch.quant import kmeans as km
from repro_torch.quant.base import PQConfig
from repro_torch.quant.pq import PQ


def distortion_grad_wrt_R(X: torch.Tensor, R: torch.Tensor,
                          codebooks: torch.Tensor) -> torch.Tensor:
    """∇_R (1/m)‖XR − φ(XR)‖² with the codes frozen (the assignment at R
    carries no gradient): the inner rotation objective, by autograd."""
    Rm = R.detach().float().requires_grad_(True)
    with torch.enable_grad():
        loss = cb.distortion(X @ Rm, codebooks.detach())
        (G,) = torch.autograd.grad(loss, Rm)
    return G


def alternating_minimization(generator: torch.Generator, X: torch.Tensor,
                             cfg: PQConfig, iters: int = 30,
                             rotation: str = "procrustes",
                             inner_steps: int = 5, lr: float = 1e-4,
                             kmeans_iters: int = 1):
    """Fixed-embedding rotation learning (paper §3.1). Returns
    (R (n, n), codebooks (D, K, sub), distortion trace (iters,)).

    ``rotation`` is any registry spec. Codebooks start from
    ``kmeans_iters`` Lloyd iterations on X (R = I); each outer iteration
    refreshes them with ``kmeans_iters`` more on XR, then moves R (the
    learner's ``solve`` toward φ(XR), ``inner_steps`` gradient updates at
    ``lr`` each drawing from ``generator``, or nothing for frozen), and
    records the distortion of the new XR."""
    learner = rotations.make(rotation)
    closed_form = hasattr(learner, "solve")
    frozen = isinstance(learner, rotations.Frozen)
    n = X.shape[-1]
    codebooks, _ = km.kmeans(generator, X, cfg, iters=kmeans_iters)
    rot = learner.init(n, dtype=X.dtype, device=X.device)
    trace = []
    for _ in range(iters):
        XR = X @ learner.materialize(rot)
        for _i in range(kmeans_iters):
            codebooks, _codes = km.kmeans_update(XR, codebooks)
        if frozen:
            pass
        elif closed_form:
            target = cb.decode(cb.assign(XR, codebooks), codebooks)
            rot, _delta = learner.solve(rot, X, target)
        else:
            for _i in range(inner_steps):
                G = distortion_grad_wrt_R(X, learner.materialize(rot),
                                          codebooks)
                rot, _delta = learner.update(rot, G, lr, generator)
        trace.append(cb.distortion(X @ learner.materialize(rot), codebooks))
    return (learner.materialize(rot), codebooks,
            torch.stack(trace) if trace
            else torch.zeros((0,), device=X.device))


def fit(generator: torch.Generator, X: torch.Tensor, cfg: PQConfig, *,
        iters: int = 30, rotation: str = "procrustes", inner_steps: int = 5,
        lr: float = 1e-4, kmeans_iters: int = 1
        ) -> tuple[torch.Tensor, PQ, torch.Tensor]:
    """Protocol-idiom entry point: (R, PQ, distortion trace)."""
    R, codebooks, trace = alternating_minimization(
        generator, X, cfg, iters=iters, rotation=rotation,
        inner_steps=inner_steps, lr=lr, kmeans_iters=kmeans_iters)
    return R, PQ(codebooks), trace
