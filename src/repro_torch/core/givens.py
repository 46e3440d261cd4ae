"""Givens rotation primitives for SO(n) coordinate descent (port of
``repro/core/givens.py``).

A Givens rotation R_ij(θ) is the identity with [i,i] = cosθ, [i,j] = −sinθ,
[j,i] = sinθ, [j,j] = cosθ. Right multiplication X·R_ij(θ) mixes columns i
and j of X:  col_i' = cosθ·col_i + sinθ·col_j,  col_j' = −sinθ·col_i +
cosθ·col_j.

``apply_pair_rotations`` takes disjoint pairs only (the givens_rotate
kernel on the card); the overlapping deltas of the paper's §3.1 ablation
are composed one pair at a time by ``rotations.base.GivensDelta``.
``project_to_so_n`` and ``random_rotation`` are library calls (an SVD, a
QR), as they are in the JAX package: no Pallas kernel computes either.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.kernels import ops as kops

SQRT2 = 1.4142135623730951


def directional_derivs(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A = GᵀR − RᵀG for G = ∇_R L, antisymmetric (n, n). A[i, j]/√2 is the
    directional derivative of L along R_ij(θ) at θ = 0 (Proposition 1)."""
    M = G.T @ R
    return M - M.T


def directional_derivs_wrt_input(X: torch.Tensor,
                                 dLdX: torch.Tensor) -> torch.Tensor:
    """Proposition 1's form: the derivative of L(X·R_ij(θ)) at θ = 0,
    ∇L(X)ᵀX − Xᵀ∇L(X), (n, n) for X (m, n)."""
    M = dLdX.T @ X
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


def apply_pair_rotations_transposed(X: torch.Tensor, pi: torch.Tensor,
                                    pj: torch.Tensor,
                                    theta: torch.Tensor) -> torch.Tensor:
    """Right-multiply X by (∏ℓ R_{iℓ,jℓ}(θℓ))ᵀ = ∏ℓ R_{iℓ,jℓ}(−θℓ)."""
    return apply_pair_rotations(X, pi, pj, -theta)


def rotation_from_pairs(pi: torch.Tensor, pj: torch.Tensor,
                        theta: torch.Tensor, n: int,
                        dtype=torch.float32) -> torch.Tensor:
    """The dense (n, n) matrix ∏ℓ R_{pi[ℓ],pj[ℓ]}(θℓ) of disjoint pairs, on
    the pairs' device (the test oracle of the pair products)."""
    eye = torch.eye(n, dtype=dtype, device=pi.device)
    return apply_pair_rotations(eye, pi, pj, theta)


def gather_pair_scores(A: torch.Tensor, pi: torch.Tensor,
                       pj: torch.Tensor) -> torch.Tensor:
    """A[pi[ℓ], pj[ℓ]] for each pair ℓ: the signed scores of a matching."""
    return A[pi.long(), pj.long()]


def project_to_so_n(R: torch.Tensor) -> torch.Tensor:
    """The SVD projection UVᵀ of R onto O(n), its last column of U flipped
    where det(UVᵀ) = −1, so the result lies in SO(n); in R's dtype.

    The SVD and the product are taken in float64 and rounded after, as
    ``rotations.procrustes.procrustes_rotation`` does: in float32 on an
    H100 a (512, 512) projection came out 2.2e-4 off orthogonal, and a
    learner that keeps R as orthogonal as it finds it would carry that."""
    U, _, Vt = torch.linalg.svd(R.double(), full_matrices=False)
    det = torch.linalg.det(U @ Vt)
    U = torch.cat([U[:, :-1], U[:, -1:] * torch.sign(det)], dim=1)
    return (U @ Vt).to(R.dtype)


def random_rotation(generator: torch.Generator, n: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """A Haar-distributed element of SO(n): the QR of a Gaussian from
    ``generator`` (on ``device``, the card by default), its columns signed
    by R's diagonal and the last one flipped to det +1."""
    dev = _device.resolve(device)
    _device.check_generator(generator, dev)
    Z = torch.randn((n, n), generator=generator, device=dev,
                    dtype=torch.float32)
    Q, Rr = torch.linalg.qr(Z)
    Q = Q * torch.sign(torch.diagonal(Rr))[None, :]
    det = torch.linalg.det(Q)
    Q = torch.cat([Q[:, :-1], Q[:, -1:] * torch.sign(det)], dim=1)
    return Q.to(dtype)
