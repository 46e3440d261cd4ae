"""Rotation learners (port of ``repro/rotations``).

    learner = rotations.make("gcd_greedy")          # or "gcd"
    learner = rotations.make("subspace_gcd", sub=8)
    state = learner.init(n, device="cuda")
    state, delta = learner.update(state, grad, lr)

Other registry names of the JAX package (Cayley, Procrustes, frozen, the
other GCD methods) raise NotImplementedError until a later slice ports
them.
"""
from __future__ import annotations

from repro_torch.core.givens import orthogonality_error  # noqa: F401
from repro_torch.rotations.base import (  # noqa: F401
    GivensDelta,
    apply,
    identity_delta,
)
from repro_torch.rotations.gcd import GCD, GCDState, SubspaceGCD  # noqa: F401

_REGISTRY = {"gcd": GCD, "gcd_greedy": GCD, "subspace_gcd": SubspaceGCD}
_LATER = ("cayley_sgd", "cayley", "procrustes", "svd", "frozen",
          "gcd_random", "gcd_steepest", "gcd_overlap_greedy",
          "gcd_overlap_random")


def names() -> tuple[str, ...]:
    return ("gcd_greedy", "subspace_gcd")


def make(spec: str, **kwargs):
    """Build a learner from a registry spec; ``kwargs`` go to its
    constructor (``sub=`` for ``subspace_gcd``)."""
    if spec in _LATER:
        raise NotImplementedError(
            f"rotation learner {spec!r} is not ported yet (ROADMAP.md "
            "queue 1, slices 2 and 7)")
    cls = _REGISTRY.get(spec)
    if cls is None:
        raise ValueError(
            f"unknown rotation learner {spec!r}; registered: {names()}")
    return cls(**kwargs)
