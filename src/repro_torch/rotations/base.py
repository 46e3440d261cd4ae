"""The rotation-learner protocol and its deltas (port of
``repro/rotations/base.py``).

Every learner implements one protocol (``RotationLearner``):

    state = learner.init(n, device=...)             # or init_from(R)
    state, delta = learner.update(state, grad, lr, generator)
    R = learner.materialize(state)

``update`` returns the new state and a delta Δ with R_new = R_old·Δ: a
``GivensDelta`` (the GCD family) or the dense factor ``DenseDelta``
(Cayley-SGD, Procrustes). ``apply`` right-multiplies any (..., n) tensor
by either, so a trainer and a live index fed the same delta stay in sync.
A disjoint ``GivensDelta`` runs the givens_rotate kernel on the card
(``core.givens.apply_pair_rotations``); an overlapping one (the paper's
§3.1 ablation, whose pairs share axes and do not commute) is composed one
pair at a time in plain PyTorch on every device, as the JAX package does
in a plain ``fori_loop``; a ``DenseDelta`` is a plain ``torch.matmul``.

``maybe_reorthonormalize`` is the learners' ``reorthonormalize_every``
guard. On a step where it fires, the state absorbs a correction that the
returned delta does not carry, as in the JAX package: a consumer syncing
a live index by deltas keeps the guard off (the default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core import givens


@dataclasses.dataclass(frozen=True)
class GivensDelta:
    """Δ = ∏ℓ R_{pi[ℓ],pj[ℓ]}(theta[ℓ]). ``pi``/``pj`` are (p,) integer
    tensors, ``theta`` (p,) float. ``overlapping`` False: the pairs are
    disjoint and commute; True: the §3.1 ablation, applied in order."""

    pi: torch.Tensor
    pj: torch.Tensor
    theta: torch.Tensor
    overlapping: bool = False

    def apply(self, X: torch.Tensor) -> torch.Tensor:
        if self.overlapping:
            return _apply_overlapping(X, self.pi, self.pj, self.theta)
        return givens.apply_pair_rotations(X, self.pi, self.pj, self.theta)


@dataclasses.dataclass(frozen=True)
class DenseDelta:
    """Δ as a dense (n, n) factor (Cayley-SGD, Procrustes)."""

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


def _apply_overlapping(X: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                       theta: torch.Tensor) -> torch.Tensor:
    """Compose possibly overlapping plane rotations one after another
    (``repro/rotations/base.py:99-115``): pair ℓ mixes columns pi[ℓ] and
    pj[ℓ] of the result of pairs 0 … ℓ−1, at θℓ in X's dtype. The pairs
    are read to the host once (one synchronisation); the columns are then
    updated in place on a copy of X, so X itself is left as it is."""
    t = theta.to(X.dtype)
    c, s = torch.cos(t), torch.sin(t)
    Y = X.clone()
    for ell, (i, j) in enumerate(zip(pi.tolist(), pj.tolist())):
        ci, cj = Y[..., i].clone(), Y[..., j].clone()
        Y[..., i] = c[ell] * ci + s[ell] * cj
        Y[..., j] = c[ell] * cj - s[ell] * ci
    return Y


@runtime_checkable
class RotationLearner(Protocol):
    """The learner protocol (see the module docstring). Implementations are
    frozen dataclasses: hyper-parameters (the pair selection, the
    preconditioner, ``reorthonormalize_every``) live on the learner, the
    per-rotation quantities (R, the step counter, accumulators) in the
    state. Random numbers come from the ``torch.Generator`` that
    ``update`` is given, on the rotation's device."""

    def init(self, n: int, dtype=torch.float32, device=None) -> Any:
        """Fresh state at R = I_n on ``device`` (the card by default)."""
        ...

    def init_from(self, R: torch.Tensor) -> Any:
        """Fresh state at an existing rotation (an OPQ warm start)."""
        ...

    def with_rotation(self, state: Any, R: torch.Tensor) -> Any:
        """The state with its rotation replaced."""
        ...

    def update(self, state: Any, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[Any, RotationDelta]:
        """One manifold step from ``grad = ∇_R L``; returns (state, Δ)."""
        ...

    def materialize(self, state: Any) -> torch.Tensor:
        """The current rotation R ∈ SO(n)."""
        ...


def maybe_reorthonormalize(R: torch.Tensor, step: torch.Tensor,
                           every: int) -> torch.Tensor:
    """R projected back onto SO(n) (``givens.project_to_so_n``, in float32
    whatever R's dtype, cast back) when the post-update counter ``step``
    is a multiple of ``every``; R as it is otherwise, and always when
    ``every`` is 0. Reads ``step`` to the host once when ``every`` > 0,
    and runs no SVD on a step where the guard does not fire."""
    if not every or int(step) % every:
        return R
    return givens.project_to_so_n(R.float()).to(R.dtype)
