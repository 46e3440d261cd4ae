"""Givens-coordinate-descent learners (port of ``repro/rotations/gcd.py``,
paper Algorithm 2):

    G  = ∇_R L
    A  = GᵀR − RᵀG                  (directional derivatives, Prop. 1)
    (pi, pj) ← n/2 disjoint pairs     (GCD-R / GCD-G / GCD-S)
    θℓ = −λ · A[iℓ, jℓ] / √2
    R  ← R · ∏ℓ R_{iℓ jℓ}(θℓ)

``SubspaceGCD`` zeroes the cross-subspace entries of A first, so every pair
with a nonzero angle stays inside one PQ subspace and the delta refreshes an
index exactly (``index.maintain.refresh_delta``). A goes through
``kernels.ops.gcd_score`` at every n: the gcd_score kernel on the card, its
plain version on the CPU.

``method`` picks the pair selection of ``core.matching``: "random"
(GCD-R, from the generator ``update`` is given), "greedy" (GCD-G) or
"steepest" (GCD-S, greedy and ``sweeps`` 2-opt sweeps). The overlapping
ablations, the adagrad/adam preconditioners and
``reorthonormalize_every`` are not ported yet (ROADMAP.md queue 1, item
7): the preconditioner is "none", so it is not a field here. ``Frozen`` is
the frozen-R control of the paper's Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import givens, matching
from repro_torch.kernels import ops as kops
from repro_torch.rotations import base

METHODS = ("random", "greedy", "steepest")
_OVERLAP = ("overlap_greedy", "overlap_random")


class GCDState(NamedTuple):
    """State of a GCD-trained rotation."""

    R: torch.Tensor       # (n, n) current rotation, in SO(n)
    step: torch.Tensor    # int32 step counter


@dataclasses.dataclass(frozen=True)
class GCD:
    """The paper's GCD family; ``method`` picks the pair selection."""

    method: str = "greedy"           # one of METHODS
    sweeps: int = 16                 # 2-opt sweeps for method="steepest"

    def __post_init__(self):
        if self.method in _OVERLAP:
            raise NotImplementedError(
                f"GCD method {self.method!r} is not ported yet (ROADMAP.md "
                "queue 1, item 7)")
        if self.method not in METHODS:
            raise ValueError(f"unknown GCD method {self.method!r}")

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

    def select_pairs(self, A: torch.Tensor,
                     generator: torch.Generator | None = None):
        """The matching step: (pi, pj) from the score field A. GCD-R draws
        from ``generator``, which must be on A's device; the port uses no
        global random state, so GCD-R without one raises ValueError."""
        if self.method == "random":
            if generator is None:
                raise ValueError("GCD-R (method='random') needs a "
                                 "torch.Generator on the rotation's device")
            return matching.random_matching(generator, A.shape[-1],
                                            device=A.device)
        if self.method == "greedy":
            return matching.greedy_matching_fast(A)
        return matching.steepest_matching(A, sweeps=self.sweeps)

    def update(self, state: GCDState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[GCDState, base.GivensDelta]:
        """One manifold step from ``grad = ∇_R L``; returns (state, Δ).
        ``generator`` feeds GCD-R's pairs; the other methods draw no random
        numbers."""
        A = self._mask(kops.gcd_score(grad.float().contiguous(),
                                      state.R.float().contiguous()))
        pi, pj = self.select_pairs(A, generator)
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
        if self.method in _OVERLAP:
            raise ValueError("SubspaceGCD requires a disjoint matching")
        super().__post_init__()
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
