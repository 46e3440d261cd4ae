"""Rotation learners (port of ``repro/rotations``).

    learner = rotations.make("gcd_greedy")          # or "gcd"
    learner = rotations.make("gcd", method="steepest")
    learner = rotations.make("subspace_gcd", sub=8)
    learner = rotations.make("cayley_sgd")          # or "cayley"
    learner = rotations.make("frozen")              # the frozen-R control
    state = learner.init(n, device="cuda")
    state, delta = learner.update(state, grad, lr, generator)

The paper's Table 1 rows are all here: frozen, cayley_sgd, gcd_random,
gcd_greedy and gcd_steepest. ``RotationConfig(learner, lr)`` is the
trainer-facing sub-config and ``from_config`` builds its learner, as in
``repro/rotations/registry.py``. The names still in ``_LATER`` (Procrustes
as a learner, the overlapping GCD ablations) raise NotImplementedError
until ROADMAP.md queue 1, item 7 ports them; ``quant.opq`` has the
closed-form Procrustes solve.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.givens import orthogonality_error  # noqa: F401
from repro_torch.rotations.base import (  # noqa: F401
    DenseDelta,
    GivensDelta,
    RotationDelta,
    apply,
    identity_delta,
)
from repro_torch.rotations.cayley import CayleySGD, CayleyState  # noqa: F401
from repro_torch.rotations.gcd import (  # noqa: F401
    GCD,
    METHODS,
    Frozen,
    FrozenState,
    GCDState,
    SubspaceGCD,
)

_REGISTRY: dict[str, type] = {"gcd": GCD, "subspace_gcd": SubspaceGCD,
                              "cayley_sgd": CayleySGD, "frozen": Frozen}
_REGISTRY.update({f"gcd_{m}": GCD for m in METHODS})
_ALIASES = {"cayley": "cayley_sgd"}
_LATER = ("procrustes", "svd", "gcd_overlap_greedy", "gcd_overlap_random")


def names() -> tuple[str, ...]:
    """The ported canonical specs, in the JAX registry's order; the bare
    "gcd" (the same learner as "gcd_greedy") and aliases are left out so a
    sweep counts each learner once."""
    return tuple(n for n in _REGISTRY if n != "gcd")


def make(spec: str, **kwargs):
    """Build a learner from a registry spec; ``kwargs`` go to its
    constructor (``method=``, ``sweeps=``, ``sub=``); a ``gcd_<method>``
    spec binds ``method`` unless it is given."""
    spec = _ALIASES.get(spec, spec)
    if spec in _LATER:
        raise NotImplementedError(f"rotation learner {spec!r} is not ported "
                                  "yet (ROADMAP.md queue 1, item 7)")
    cls = _REGISTRY.get(spec)
    if cls is None:
        raise ValueError(
            f"unknown rotation learner {spec!r}; registered: {names()}")
    if spec.startswith("gcd_"):
        kwargs.setdefault("method", spec[len("gcd_"):])
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
