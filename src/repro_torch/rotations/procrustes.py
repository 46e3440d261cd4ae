"""Orthogonal Procrustes (port of ``repro/rotations/procrustes.py:30-34``).

The closed-form solve OPQ alternates with k-means. The port has it as a
function, not yet as a learner with a projected-SGD ``update``: that one
waits with the rest of the learner registry (ROADMAP.md queue 1, slice 7).
The SVD is ``torch.linalg.svd``, a library call: it is no Pallas kernel in
the JAX package either. It is taken in float64 and the rotation rounded to
float32 after: in float32 on an H100 the (512, 512) solve of the OPQ warm
start came out 2.2e-4 away from orthogonal (chip_smoke.py, train phase),
and GCD, which keeps R exactly as orthogonal as it finds it, would carry
that error through training.
"""
from __future__ import annotations

import torch


def procrustes_rotation(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """argmin over R ∈ O(n) of ‖XR − Y‖_F = UVᵀ with XᵀY = USVᵀ
    (Schönemann 1966). O(n), not SO(n): OPQ permits reflections."""
    M = (X.T @ Y).double()
    U, _, Vt = torch.linalg.svd(M, full_matrices=False)
    return (U @ Vt).to(X.dtype)
