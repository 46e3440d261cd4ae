"""Givens-coordinate-descent learners (port of ``repro/rotations/gcd.py``,
paper Algorithm 2):

    G  = ∇_R L
    A  = GᵀR − RᵀG                  (directional derivatives, Prop. 1)
    (pi, pj) ← greedy disjoint matching on |A|
    θℓ = −λ · A[iℓ, jℓ] / √2
    R  ← R · ∏ℓ R_{iℓ jℓ}(θℓ)

``SubspaceGCD`` zeroes the cross-subspace entries of A first, so every pair
with a nonzero angle stays inside one PQ subspace and the delta refreshes an
index exactly (``index.maintain.refresh_delta``). A goes through
``kernels.ops.gcd_score`` at every n: the gcd_score kernel on the card, its
plain version on the CPU.

The port has pair selection ``method="greedy"`` with preconditioner
``"none"`` only, so neither is a field here; the registry names of the
other methods raise NotImplementedError until a later slice ports them.
``Frozen`` is the frozen-R control of the paper's Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import givens, matching
from repro_torch.kernels import ops as kops
from repro_torch.rotations import base


class GCDState(NamedTuple):
    """State of a GCD-trained rotation."""

    R: torch.Tensor       # (n, n) current rotation, in SO(n)
    step: torch.Tensor    # int32 step counter


@dataclasses.dataclass(frozen=True)
class GCD:
    """The paper's GCD learner with greedy pair selection (GCD-G)."""

    def init(self, n: int, dtype=torch.float32, device=None) -> GCDState:
        """Fresh state at R = I_n on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return self.init_from(torch.eye(n, dtype=dtype, device=dev))

    def init_from(self, R: torch.Tensor) -> GCDState:
        return GCDState(R=R, step=torch.zeros((), dtype=torch.int32,
                                              device=R.device))

    def with_rotation(self, state: GCDState, R: torch.Tensor) -> GCDState:
        return state._replace(R=R)

    def materialize(self, state: GCDState) -> torch.Tensor:
        return state.R

    def update(self, state: GCDState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[GCDState, base.GivensDelta]:
        """One manifold step from ``grad = ∇_R L``; returns (state, Δ).
        ``generator`` is accepted for the learner protocol; greedy pair
        selection draws no random numbers."""
        del generator
        A = self._mask(kops.gcd_score(grad.float().contiguous(),
                                      state.R.float().contiguous()))
        pi, pj = matching.greedy_matching_fast(A)
        theta = -float(lr) * A[pi, pj] / givens.SQRT2
        delta = base.GivensDelta(pi=pi, pj=pj, theta=theta)
        new = GCDState(R=delta.apply(state.R), step=state.step + 1)
        return new, delta

    def _mask(self, A: torch.Tensor) -> torch.Tensor:
        return A


@dataclasses.dataclass(frozen=True)
class SubspaceGCD(GCD):
    """GCD with the matching restricted to within-subspace planes; ``sub``
    is the PQ subspace width (n // num_subspaces)."""

    sub: int = 0

    def __post_init__(self):
        if self.sub <= 0:
            raise ValueError("SubspaceGCD needs sub > 0 (the subspace width)")

    def _mask(self, A: torch.Tensor) -> torch.Tensor:
        d = torch.arange(A.shape[-1], device=A.device) // self.sub
        return torch.where(d[:, None] == d[None, :], A, torch.zeros_like(A))


class FrozenState(NamedTuple):
    R: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Frozen:
    """The frozen-R control: ``update`` leaves R as it is and returns the
    identity delta."""

    def init(self, n: int, dtype=torch.float32, device=None) -> FrozenState:
        dev = _device.resolve(device)
        return self.init_from(torch.eye(n, dtype=dtype, device=dev))

    def init_from(self, R: torch.Tensor) -> FrozenState:
        return FrozenState(R=R, step=torch.zeros((), dtype=torch.int32,
                                                 device=R.device))

    def with_rotation(self, state: FrozenState,
                      R: torch.Tensor) -> FrozenState:
        return state._replace(R=R)

    def materialize(self, state: FrozenState) -> torch.Tensor:
        return state.R

    def update(self, state: FrozenState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[FrozenState, base.GivensDelta]:
        del grad, lr, generator
        return (state._replace(step=state.step + 1),
                base.identity_delta(state.R.dtype, state.R.device))
