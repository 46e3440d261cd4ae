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
(GCD-R, from the generator ``update`` is given), "greedy" (GCD-G),
"steepest" (GCD-S, greedy and ``sweeps`` 2-opt sweeps), or the paper's
§3.1 overlapping ablations "overlap_greedy" (the top n/2 edges of |Â|)
and "overlap_random" (n/2 random edges), whose deltas are applied pair
after pair. ``preconditioner`` rescales the field elementwise before the
matching ("none", "adagrad" or "adam", with the JAX package's β and ε),
and θ is taken from the rescaled field Â. ``reorthonormalize_every``
projects R back onto SO(n) every that many steps (0, the default: never;
GCD needs no guard in float32). ``Frozen`` is the frozen-R control of the
paper's Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import givens, matching
from repro_torch.kernels import ops as kops
from repro_torch.rotations import base

METHODS = ("random", "greedy", "steepest", "overlap_greedy", "overlap_random")
PRECONDITIONERS = ("none", "adagrad", "adam")


class GCDState(NamedTuple):
    """State of a GCD-trained rotation."""

    R: torch.Tensor       # (n, n) current rotation, in SO(n)
    step: torch.Tensor    # int32 step counter
    accum: torch.Tensor   # (n, n) float32: adagrad's sum of Â², adam's m
    accum2: torch.Tensor  # (n, n) float32: adam's v (unused by adagrad)


def _precondition(state: GCDState, A: torch.Tensor, preconditioner: str,
                  beta1: float = 0.9, beta2: float = 0.999,
                  eps: float = 1e-8):
    """(Â, accum, accum2): the field rescaled elementwise
    (``repro/rotations/gcd.py:48-69``) and the accumulators after it."""
    if preconditioner == "none":
        return A, state.accum, state.accum2
    t = state.step.float() + 1.0
    if preconditioner == "adagrad":
        acc = state.accum + torch.square(A)
        return A / (torch.sqrt(acc) + eps), acc, state.accum2
    if preconditioner == "adam":
        m = beta1 * state.accum + (1.0 - beta1) * A
        v = beta2 * state.accum2 + (1.0 - beta2) * torch.square(A)
        mhat = m / (1.0 - beta1 ** t)
        vhat = v / (1.0 - beta2 ** t)
        return mhat / (torch.sqrt(vhat) + eps), m, v
    raise ValueError(f"unknown preconditioner {preconditioner!r}")


@dataclasses.dataclass(frozen=True)
class GCD:
    """The paper's GCD family; ``method`` picks the pair selection."""

    method: str = "greedy"           # one of METHODS
    preconditioner: str = "none"     # none | adagrad | adam
    sweeps: int = 16                 # 2-opt sweeps for method="steepest"
    reorthonormalize_every: int = 0  # 0 = never (exact in float32)

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown GCD method {self.method!r}")
        if self.preconditioner not in PRECONDITIONERS:
            raise ValueError(
                f"unknown preconditioner {self.preconditioner!r}")

    def init(self, n: int, dtype=torch.float32, device=None) -> GCDState:
        """Fresh state at R = I_n on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return self.init_from(torch.eye(n, dtype=dtype, device=dev))

    def init_from(self, R: torch.Tensor) -> GCDState:
        n = R.shape[-1]
        zeros = torch.zeros((n, n), dtype=torch.float32, device=R.device)
        return GCDState(R=R, step=torch.zeros((), dtype=torch.int32,
                                              device=R.device),
                        accum=zeros, accum2=zeros.clone())

    def with_rotation(self, state: GCDState, R: torch.Tensor) -> GCDState:
        return state._replace(R=R)

    def materialize(self, state: GCDState) -> torch.Tensor:
        return state.R

    def select_pairs(self, A: torch.Tensor,
                     generator: torch.Generator | None = None):
        """The matching step: (pi, pj) from the (preconditioned) score
        field. The random methods draw from ``generator``, which must be on
        A's device; the port uses no global random state, so they raise
        ValueError without one."""
        n = A.shape[-1]
        if self.method in ("random", "overlap_random"):
            if generator is None:
                raise ValueError(f"GCD method {self.method!r} needs a "
                                 "torch.Generator on the rotation's device")
            if self.method == "random":
                return matching.random_matching(generator, n,
                                                device=A.device)
            return matching.overlapping_random(generator, n,
                                               device=A.device)
        if self.method == "greedy":
            return matching.greedy_matching_fast(A)
        if self.method == "steepest":
            return matching.steepest_matching(A, sweeps=self.sweeps)
        return matching.overlapping_topk(A)

    def update(self, state: GCDState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[GCDState, base.GivensDelta]:
        """One manifold step from ``grad = ∇_R L``; returns (state, Δ).
        ``generator`` feeds the random methods' pairs; the others draw no
        random numbers."""
        A = self._mask(kops.gcd_score(grad.float().contiguous(),
                                      state.R.float().contiguous()))
        Ahat, acc, acc2 = _precondition(state, A, self.preconditioner)
        pi, pj = self.select_pairs(Ahat, generator)
        theta = -float(lr) * Ahat[pi, pj] / givens.SQRT2
        delta = base.GivensDelta(
            pi=pi, pj=pj, theta=theta,
            overlapping=self.method.startswith("overlap"))
        step = state.step + 1
        R_new = base.maybe_reorthonormalize(
            delta.apply(state.R), step, self.reorthonormalize_every)
        return GCDState(R=R_new, step=step, accum=acc, accum2=acc2), delta

    def _mask(self, A: torch.Tensor) -> torch.Tensor:
        return A


@dataclasses.dataclass(frozen=True)
class SubspaceGCD(GCD):
    """GCD with the matching restricted to within-subspace planes; ``sub``
    is the PQ subspace width (n // num_subspaces)."""

    sub: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.sub <= 0:
            raise ValueError("SubspaceGCD needs sub > 0 (the subspace width)")
        if self.method.startswith("overlap"):
            raise ValueError("SubspaceGCD requires a disjoint matching")

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

    reorthonormalize_every: int = 0  # accepted for config uniformity; unused

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
