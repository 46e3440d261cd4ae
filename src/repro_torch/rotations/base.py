"""Rotation deltas (port of ``repro/rotations/base.py``).

A learner's ``update`` returns the new state and a delta Δ with
R_new = R_old·Δ: the disjoint ``GivensDelta`` that GCD emits, or the dense
factor ``DenseDelta`` of Cayley-SGD. ``apply`` right-multiplies any
(..., n) tensor by either, so a trainer and a live index fed the same
delta stay in sync. A ``GivensDelta`` runs the givens_rotate kernel on the
card (``core.givens.apply_pair_rotations``); a ``DenseDelta`` is a plain
``torch.matmul``. The overlapping ablation waits for a later slice
(ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import givens


@dataclasses.dataclass(frozen=True)
class GivensDelta:
    """Δ = ∏ℓ R_{pi[ℓ],pj[ℓ]}(theta[ℓ]) over disjoint (commuting) pairs.
    ``pi``/``pj`` are (p,) integer tensors, ``theta`` (p,) float."""

    pi: torch.Tensor
    pj: torch.Tensor
    theta: torch.Tensor

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        return givens.apply_pair_rotations(X, self.pi, self.pj, self.theta)


@dataclasses.dataclass(frozen=True)
class DenseDelta:
    """Δ as a dense (n, n) factor (Cayley-SGD)."""

    dR: torch.Tensor

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        return X @ self.dR.to(X.dtype)


RotationDelta = GivensDelta | DenseDelta


def apply(X: torch.Tensor, delta: RotationDelta) -> torch.Tensor:
    """Right-multiply X (..., n) by the delta's group element Δ."""
    return delta.apply(X)


def identity_delta(dtype=torch.float32, device=None) -> GivensDelta:
    """The empty Givens product: Δ = I."""
    z = torch.zeros((0,), dtype=torch.int64, device=device)
    return GivensDelta(pi=z, pj=z, theta=torch.zeros((0,), dtype=dtype,
                                                       device=device))
