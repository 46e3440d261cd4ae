"""Givens rotation primitives for SO(n) coordinate descent (port of
``repro/core/givens.py``).

A Givens rotation R_ij(θ) is the identity with [i,i] = cosθ, [i,j] = −sinθ,
[j,i] = sinθ, [j,j] = cosθ. Right multiplication X·R_ij(θ) mixes columns i
and j of X:  col_i' = cosθ·col_i + sinθ·col_j,  col_j' = −sinθ·col_i +
cosθ·col_j.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

SQRT2 = 1.4142135623730951


def directional_derivs(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A = GᵀR − RᵀG for G = ∇_R L, antisymmetric (n, n). A[i, j]/√2 is the
    directional derivative of L along R_ij(θ) at θ = 0 (Proposition 1)."""
    M = G.T @ R
    return M - M.T


def apply_pair_rotations(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                         theta: torch.Tensor) -> torch.Tensor:
    """Right-multiply X (..., n) by ∏_ℓ R_{pi[ℓ], pj[ℓ]}(theta[ℓ]).

    Pairs must be disjoint; columns outside every pair pass through. O(m·p)
    work for p pairs, no matmul. Returns a new tensor, differentiable in X
    and θ. Goes through ``kernels.ops.apply_pair_rotations``: the
    givens_rotate kernel on the card, its plain version on the CPU."""
    return kops.apply_pair_rotations(X, pi, pj, theta)


def orthogonality_error(R: torch.Tensor) -> torch.Tensor:
    """‖RᵀR − I‖_max — the drift diagnostic (0 up to rounding for GCD)."""
    n = R.shape[-1]
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    return torch.max(torch.abs(R.T @ R - eye))
