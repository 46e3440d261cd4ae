"""Rotation learners (port of ``repro/rotations``).

    learner = rotations.make("gcd_greedy")          # or "gcd"
    learner = rotations.make("subspace_gcd", sub=8)
    learner = rotations.make("frozen")              # the frozen-R control
    state = learner.init(n, device="cuda")
    state, delta = learner.update(state, grad, lr)

``RotationConfig(learner, lr)`` is the trainer-facing sub-config and
``from_config`` builds its learner, as in ``repro/rotations/registry.py``.
Other registry names of the JAX package (Cayley, Procrustes as a learner,
the other GCD methods and preconditioners) raise NotImplementedError until
a later slice ports them; ``quant.opq`` has the closed-form Procrustes
solve.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.givens import orthogonality_error  # noqa: F401
from repro_torch.rotations.base import (  # noqa: F401
    GivensDelta,
    apply,
    identity_delta,
)
from repro_torch.rotations.gcd import (  # noqa: F401
    GCD,
    Frozen,
    FrozenState,
    GCDState,
    SubspaceGCD,
)

_REGISTRY = {"gcd": GCD, "gcd_greedy": GCD, "subspace_gcd": SubspaceGCD,
             "frozen": Frozen}
_LATER = ("cayley_sgd", "cayley", "procrustes", "svd", "gcd_random",
          "gcd_steepest", "gcd_overlap_greedy", "gcd_overlap_random")


def names() -> tuple[str, ...]:
    return ("gcd_greedy", "subspace_gcd", "frozen")


def make(spec: str, **kwargs):
    """Build a learner from a registry spec; ``kwargs`` go to its
    constructor (``sub=`` for ``subspace_gcd``)."""
    if spec in _LATER:
        raise NotImplementedError(f"rotation learner {spec!r} is not ported "
                                  "yet (ROADMAP.md queue 1, slice 7)")
    cls = _REGISTRY.get(spec)
    if cls is None:
        raise ValueError(
            f"unknown rotation learner {spec!r}; registered: {names()}")
    return cls(**kwargs)


class RotationConfig(NamedTuple):
    """Trainer-facing rotation settings (``repro/rotations/registry.py``):
    ``learner`` is a registry spec for ``make``, ``lr`` the manifold
    learning rate passed to ``learner.update``."""

    learner: str = "gcd_greedy"
    lr: float = 1e-3


def from_config(cfg: RotationConfig, **extra):
    """Learner instance for a RotationConfig (``extra`` for ``sub``)."""
    return make(cfg.learner, **extra)
