"""GCD rotation refresh of a live index and its health (port of
``repro/index/maintain.py:46-83`` and ``:114-210``).

A GCD step updates the rotation by a product of disjoint Givens rotations,
R ← R·Δ. Under Δ every stored quantity transforms by right multiplication
in the rotated space (x·R' = x·R·Δ, centroids' = centroids·Δ), so the
coarse assignment is invariant, and the part of Δ inside one PQ subspace
rotates that subspace's codewords exactly: codes stay as they are.
Cross-subspace pairs cannot be absorbed by a product codebook and are
dropped (θ → 0) for it. The refresh costs O(n² + L·n + D·K·sub),
independent of the corpus size.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core import givens
from repro_torch.index import ivf
from repro_torch.index.ivf import IVFPQIndex
from repro_torch.rotations import GivensDelta


def refresh_health(R: torch.Tensor, delta: GivensDelta | None = None, *,
                   registry: obs.Registry | None = None) -> dict:
    """Host-side refresh health, recorded on ``registry`` (default: the
    global ``repro_torch.obs`` registry):

      * ``refresh.orthogonality_drift``: ‖RᵀR − I‖ of the serving rotation
        after the refresh; repeated float32 delta products slowly leave
        SO(n), and drift degrades every stored code at once;
      * ``refresh.delta_norm``: ‖θ‖ of the GivensDelta; a spiking norm is
        a runaway learner, visible before recall moves.

    One host synchronisation on the (n, n) rotation: call it per refresh,
    not per query. Returns the measured values whether or not the registry
    is enabled."""
    reg = registry if registry is not None else obs.default_registry()
    drift = float(givens.orthogonality_error(R))
    norm = None
    if delta is not None:
        norm = float(torch.linalg.vector_norm(check_refreshable(delta).theta
                                              .double()))
        reg.gauge("refresh.delta_norm").set(norm)
    reg.gauge("refresh.orthogonality_drift").set(drift)
    reg.counter("refresh.count").inc()
    reg.event("refresh", orthogonality_drift=drift, delta_norm=norm)
    return dict(orthogonality_drift=drift, delta_norm=norm)


def rotate_components(R: torch.Tensor, coarse, quantizer, pi: torch.Tensor,
                      pj: torch.Tensor, theta: torch.Tensor):
    """Rotate R, the coarse centroids and the residual codebooks by a
    disjoint plane product; codes never enter."""
    sub = quantizer.sub
    R_new = givens.apply_pair_rotations(R, pi, pj, theta)
    coarse_new = coarse.rotate(pi, pj, theta)
    within = torch.div(pi, sub, rounding_mode="floor") == torch.div(
        pj, sub, rounding_mode="floor")
    theta_w = torch.where(within, theta, torch.zeros_like(theta))
    quantizer_new = quantizer.rotate(pi, pj, theta_w)
    return R_new, coarse_new, quantizer_new


def check_refreshable(delta) -> GivensDelta:
    """The refresh precondition: a disjoint GivensDelta."""
    if not isinstance(delta, GivensDelta):
        raise TypeError(
            f"refresh needs a GivensDelta (got {type(delta).__name__}): "
            "dense deltas do not factor into per-subspace codebook "
            "rotations — re-encode (ivf.build) instead")
    return delta


def refresh_rotation(index: IVFPQIndex, pi: torch.Tensor, pj: torch.Tensor,
                     theta: torch.Tensor) -> IVFPQIndex:
    """Absorb R ← R·∏ℓ R_{pi[ℓ],pj[ℓ]}(theta[ℓ]) without touching codes."""
    R_new, coarse_new, quantizer_new = rotate_components(
        index.R, index.coarse, index.quantizer, pi, pj, theta)
    return dataclasses.replace(index, R=R_new, coarse=coarse_new,
                               quantizer=quantizer_new)


def refresh_delta(index: IVFPQIndex, delta: GivensDelta) -> IVFPQIndex:
    """``refresh_rotation`` for a learner's delta: the served rotation then
    equals the learner's ``state.R`` exactly."""
    check_refreshable(delta)
    return refresh_rotation(index, delta.pi, delta.pj, delta.theta)


def refresh_mismatch(refreshed: IVFPQIndex, X: torch.Tensor) -> float:
    """Fraction of live items whose stored codes differ from a full
    re-encode of the raw vectors ``X`` (rows ordered by item id) against
    the refreshed index."""
    X = X.to(refreshed.device)
    _, rebuilt = ivf.encode(X @ refreshed.R, refreshed.coarse,
                            refreshed.quantizer)
    live = refreshed.ids >= 0
    stored = refreshed.codes.to(torch.int32)
    again = rebuilt[torch.clamp(refreshed.ids, min=0).long()]
    mismatch = torch.any(stored != again, dim=-1) & live
    return float(torch.sum(mismatch)) / max(int(torch.sum(live)), 1)
