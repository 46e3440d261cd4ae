"""Rotation learners (port of ``repro/rotations``), one protocol
(``base.RotationLearner``) and one string registry:

    learner = rotations.make("gcd_greedy")          # or "gcd"
    learner = rotations.make("gcd", method="steepest", preconditioner="adam")
    learner = rotations.make("subspace_gcd", sub=8)
    learner = rotations.make("cayley_sgd")          # or "cayley"
    learner = rotations.make("procrustes")          # or "svd"
    learner = rotations.make("frozen")              # the frozen-R control
    state = learner.init(n, device="cuda")
    state, delta = learner.update(state, grad, lr, generator)

``names()`` is the JAX registry's tuple, in its order: the paper's Table 1
rows, Procrustes and the overlapping GCD ablations
(``gcd_overlap_greedy``, ``gcd_overlap_random``). ``RotationConfig`` is the
trainer-facing sub-config and ``from_config`` builds its learner, as in
``repro/rotations/registry.py``.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.givens import (  # noqa: F401
    apply_pair_rotations,
    orthogonality_error,
    project_to_so_n,
    random_rotation,
)
from repro_torch.rotations.base import (  # noqa: F401
    DenseDelta,
    GivensDelta,
    RotationDelta,
    RotationLearner,
    apply,
    identity_delta,
    maybe_reorthonormalize,
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
from repro_torch.rotations.procrustes import (  # noqa: F401
    Procrustes,
    ProcrustesState,
)

_REGISTRY: dict[str, type] = {"gcd": GCD, "subspace_gcd": SubspaceGCD,
                              "cayley_sgd": CayleySGD,
                              "procrustes": Procrustes, "frozen": Frozen}
_REGISTRY.update({f"gcd_{m}": GCD for m in METHODS})
_ALIASES = {"svd": "procrustes", "cayley": "cayley_sgd"}


def names() -> tuple[str, ...]:
    """The canonical specs, in the JAX registry's order; the bare "gcd"
    (the same learner as "gcd_greedy") and aliases are left out so a
    sweep counts each learner once."""
    return tuple(n for n in _REGISTRY if n != "gcd")


def canonical(spec: str) -> str:
    return _ALIASES.get(spec, spec)


def make(spec: str, **kwargs):
    """Build a learner from a registry spec; ``kwargs`` go to its
    constructor (``method=``, ``preconditioner=``, ``sweeps=``, ``sub=``,
    ``reorthonormalize_every=``); a ``gcd_<method>`` spec binds ``method``
    unless it is given."""
    spec = canonical(spec)
    cls = _REGISTRY.get(spec)
    if cls is None:
        raise ValueError(
            f"unknown rotation learner {spec!r}; registered: {names()}")
    if spec.startswith("gcd_"):
        kwargs.setdefault("method", spec[len("gcd_"):])
    return cls(**kwargs)


class RotationConfig(NamedTuple):
    """Trainer-facing rotation settings (``repro/rotations/registry.py``):
    ``learner`` is a registry spec for ``make``; ``method``,
    ``preconditioner`` and ``sweeps`` apply to the GCD family only (a
    ``gcd_<method>`` spec wins over ``method``); ``lr`` is the manifold
    learning rate passed to ``learner.update``."""

    learner: str = "gcd"
    lr: float = 1e-3
    method: str = "greedy"
    preconditioner: str = "none"
    sweeps: int = 16
    reorthonormalize_every: int = 0

    @classmethod
    def from_spec(cls, spec: str, **kw) -> "RotationConfig":
        """A RotationConfig from a registry spec string:
        ``from_spec("gcd_steepest", lr=2e-3)``."""
        spec = canonical(spec)
        if spec.startswith("gcd_"):
            return cls(learner="gcd", method=spec[len("gcd_"):], **kw)
        return cls(learner=spec, **kw)


def from_config(cfg: RotationConfig, **extra):
    """Learner instance for a RotationConfig (``extra`` for ``sub``)."""
    spec = canonical(cfg.learner)
    kw = dict(reorthonormalize_every=cfg.reorthonormalize_every, **extra)
    if spec == "gcd" or spec.startswith("gcd_") or spec == "subspace_gcd":
        kw.update(preconditioner=cfg.preconditioner, sweeps=cfg.sweeps)
        if spec == "gcd":
            kw.update(method=cfg.method)
    return make(spec, **kw)
