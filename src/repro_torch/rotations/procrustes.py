"""SVD/Procrustes rotation learner (port of
``repro/rotations/procrustes.py``), the classic OPQ rotation solver.

Two entry points share one state:

  * ``update(state, grad, lr, generator)``: projected Riemannian SGD, the
    Euclidean step R − lr·G projected back onto SO(n) by a full SVD
    (``core.givens.project_to_so_n``). This is the cost of "an SVD inside
    an SGD loop", the paper's Fig 4 comparison point.
  * ``solve(state, X, target)``: the closed form
    argmin over R ∈ O(n) of ‖XR − target‖_F = UVᵀ (Schönemann 1966), which
    OPQ's alternating minimisation takes. O(n), not SO(n): OPQ permits
    reflections.

Both return a ``DenseDelta`` Δ = R_oldᵀ·R_new. The SVD is
``torch.linalg.svd``, a library call: it is no Pallas kernel in the JAX
package either. It is taken in float64 and the rotation rounded to float32
after: in float32 on an H100 the (512, 512) solve of the OPQ warm start
came out 2.2e-4 away from orthogonal (chip_smoke.py, train phase), and
GCD, which keeps R exactly as orthogonal as it finds it, would carry that
error through training.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import givens
from repro_torch.rotations import base


def procrustes_rotation(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """argmin over R ∈ O(n) of ‖XR − Y‖_F = UVᵀ with XᵀY = USVᵀ
    (Schönemann 1966). O(n), not SO(n): OPQ permits reflections."""
    M = (X.T @ Y).double()
    U, _, Vt = torch.linalg.svd(M, full_matrices=False)
    return (U @ Vt).to(X.dtype)


class ProcrustesState(NamedTuple):
    R: torch.Tensor       # (n, n) current rotation
    step: torch.Tensor    # int32 step counter


@dataclasses.dataclass(frozen=True)
class Procrustes:
    """The SVD learner: projected SGD ``update`` and closed-form ``solve``
    (see the module docstring)."""

    reorthonormalize_every: int = 0  # projected every step already; unused

    def init(self, n: int, dtype=torch.float32,
             device=None) -> ProcrustesState:
        """Fresh state at R = I_n on ``device`` (the card by default)."""
        dev = _device.resolve(device)
        return self.init_from(torch.eye(n, dtype=dtype, device=dev))

    def init_from(self, R: torch.Tensor) -> ProcrustesState:
        return ProcrustesState(R=R, step=torch.zeros((), dtype=torch.int32,
                                                     device=R.device))

    def with_rotation(self, state: ProcrustesState,
                      R: torch.Tensor) -> ProcrustesState:
        return state._replace(R=R)

    def materialize(self, state: ProcrustesState) -> torch.Tensor:
        return state.R

    def _step_to(self, state: ProcrustesState, R_new: torch.Tensor):
        delta = base.DenseDelta(dR=state.R.float().T @ R_new.float())
        return (ProcrustesState(R=R_new.to(state.R.dtype),
                                step=state.step + 1), delta)

    def update(self, state: ProcrustesState, grad: torch.Tensor, lr: float,
               generator: torch.Generator | None = None
               ) -> tuple[ProcrustesState, base.DenseDelta]:
        """R ← project_to_so_n(R − lr·G); returns (state, Δ).
        Deterministic: ``generator`` is accepted for the learner protocol
        and not used."""
        del generator
        stepped = state.R.float() - float(lr) * grad.float()
        return self._step_to(state, givens.project_to_so_n(stepped))

    def solve(self, state: ProcrustesState, X: torch.Tensor,
              target: torch.Tensor
              ) -> tuple[ProcrustesState, base.DenseDelta]:
        """The closed-form inner solve of OPQ: R ← argmin ‖XR − target‖_F."""
        return self._step_to(state, procrustes_rotation(X, target))
