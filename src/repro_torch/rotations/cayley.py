"""Cayley-transform math and the Cayley-SGD learner (port of
``repro/rotations/cayley.py``; paper §1.1, §3).

R(A) = (I − A)(I + A)⁻¹ with A skew-symmetric, parameterised by the strict
lower triangle of an (n, n) matrix. Every evaluation costs an n×n linear
solve: the paper's motivation for GCD, and the cost its Fig 4 compares.
The solves are ``torch.linalg.solve``, a library call: Cayley is no Pallas
kernel in the JAX package either.

``inverse_cayley`` solves against I + R, which is singular when R has an
eigenvalue at −1 (a half-turn in some plane). It goes through
``stable_solve``: the direct LU solution when it is finite and
backward-consistent, else the Tikhonov-regularised normal equations. Both
are computed and one is picked by ``torch.where``, so nothing waits for
the host. ``cayley`` needs no guard: I + A has eigenvalues 1 + iλ for skew
A.

``CayleySGD`` pulls the rotation gradient back through the transform at
A = 0 by an exact vjp through the solve (``torch.func.vjp``) and retracts
R ← R · cayley(−lr·∇A); the delta is that dense factor.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.rotations import base


def skew_from_params(params: torch.Tensor) -> torch.Tensor:
    """Antisymmetrise: A = tril(params, −1) − tril(params, −1)ᵀ."""
    L = torch.tril(params, -1)
    return L - L.T


def stable_solve(M: torch.Tensor, B: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Solve M X = B, surviving a (near-)singular M.

    The direct LU solution when it is finite and ‖M·X − B‖ ≤ 1e-3 ·
    max(‖B‖, 1); otherwise the solution of the regularised normal
    equations (MᵀM + (eps·max(‖M‖, 1))²·I) X = MᵀB, which are always
    nonsingular. ``solve_ex`` does not raise on a singular M: its inf or
    nan fails the test and the regularised solution is taken."""
    n = M.shape[-1]
    X, _info = torch.linalg.solve_ex(M, B)
    scale = torch.clamp(torch.linalg.matrix_norm(M), min=1.0)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    reg = torch.linalg.solve(M.T @ M + (eps * scale) ** 2 * eye, M.T @ B)
    resid = torch.linalg.matrix_norm(M @ X - B)
    ok = torch.all(torch.isfinite(X)) & (
        resid <= 1e-3 * torch.clamp(torch.linalg.matrix_norm(B), min=1.0))
    return torch.where(ok, X, reg)


def cayley(params: torch.Tensor) -> torch.Tensor:
    """R = (I + A)⁻¹(I − A) ∈ SO(n), A = skew(params), by one plain LU
    solve (the two factors commute)."""
    A = skew_from_params(params)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(eye + A, eye - A)


def inverse_cayley(R: torch.Tensor) -> torch.Tensor:
    """The params form of A with cayley(A) == R: A = (I − R)(I + R)⁻¹,
    finite at a −1 eigenvalue through ``stable_solve``."""
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    A = stable_solve((eye + R).T, (eye - R).T).T
    return torch.tril(A, -1)


def init(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity rotation's params: A = 0, on ``device`` (the card by
    default)."""
    return torch.zeros((n, n), dtype=dtype, device=_device.resolve(device))


class CayleyState(NamedTuple):
    R: torch.Tensor       # (n, n) current rotation
    step: torch.Tensor    # int32 step counter


@dataclasses.dataclass(frozen=True)
class CayleySGD:
    """Riemannian SGD with the Cayley retraction, re-centred every step:

        gA = ∇_A L(R·cayley(A)) at A = 0   (exact vjp through the solve)
        Δ  = cayley(−lr · gA)
        R  ← R · Δ

    ``reorthonormalize_every`` > 0 projects R back onto SO(n) every that
    many steps (``base.maybe_reorthonormalize``).
    """

    reorthonormalize_every: int = 0

    def init(self, n: int, dtype=torch.float32, device=None) -> CayleyState:
        """Fresh state at R = I_n on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return self.init_from(torch.eye(n, dtype=dtype, device=dev))

    def init_from(self, R: torch.Tensor) -> CayleyState:
        return CayleyState(R=R, step=torch.zeros((), dtype=torch.int32,
                                                 device=R.device))

    def with_rotation(self, state: CayleyState,
                      R: torch.Tensor) -> CayleyState:
        return state._replace(R=R)

    def materialize(self, state: CayleyState) -> torch.Tensor:
        return state.R

    def update(self, state: CayleyState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[CayleyState, base.DenseDelta]:
        """One retraction step from ``grad = ∇_R L``; returns (state, Δ).
        Deterministic: ``generator`` is accepted for the learner protocol
        and not used. ``torch.func.vjp`` differentiates whatever the
        caller's grad mode (the optimizer runs under ``no_grad``)."""
        del generator
        R32 = state.R.float()
        _, vjp = torch.func.vjp(lambda p: R32 @ cayley(p),
                                torch.zeros_like(R32))
        (gA,) = vjp(grad.float())
        delta = base.DenseDelta(dR=cayley(-float(lr) * gA))
        step = state.step + 1
        R_new = base.maybe_reorthonormalize(
            delta.apply(state.R), step, self.reorthonormalize_every)
        return CayleyState(R=R_new, step=step), delta
