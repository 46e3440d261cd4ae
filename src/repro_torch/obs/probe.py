"""Sampling recall probe: live retrieval quality as a gauge (port of
``repro/obs/probe.py``).

Latency metrics catch a slow server, not one that got fast by returning
the wrong neighbours. A rotation refresh that drifts the serving transform
away from the stored codes lowers recall while every latency number stays
green. ``RecallProbe`` holds a small pinned query set and its exact-MIPS
truth (rotation-invariant: for orthogonal R the exact backend's scores
(QR)(XR)ᵀ = QXᵀ do not depend on R, so the truth stays valid across every
refresh), replays it through the serving path every ``every``-th request
and publishes ``<name>.recall_at_k`` as a gauge. ``search.Engine`` runs an
attached probe itself; probe traffic takes the normal serving path and is
counted like any other request.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.metrics import recall_at_k
from repro_torch.obs import registry as reg_mod


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class RecallProbe:
    """Replay a pinned query set and gauge recall@k against exact truth.

    ``registry=None`` publishes to the global registry (a no-op until
    ``obs.enable()``); ``last`` holds the latest recall either way.
    ``queries`` are kept as given (a tensor stays on its device)."""

    def __init__(self, queries, truth_ids, *, k: int = 10, every: int = 64,
                 name: str = "probe",
                 registry: reg_mod.Registry | None = None):
        self.queries = queries
        truth_ids = _host(truth_ids)
        if truth_ids.shape[1] < k:
            raise ValueError(
                f"truth has {truth_ids.shape[1]} ids per row, need k={k}")
        self.truth = truth_ids[:, :k]
        self.k = k
        self.every = max(1, every)
        self.name = name
        self.registry = registry
        self.last: float | None = None
        self._since = 0

    @classmethod
    def from_exact(cls, corpus, R, queries, *, k: int = 10, every: int = 64,
                   tile_rows: int = 4096, name: str = "probe",
                   registry: reg_mod.Registry | None = None,
                   device=None) -> "RecallProbe":
        """The truth from one pass of the port's ``exact`` backend over the
        corpus on ``device`` (the card by default), once, at construction."""
        from repro_torch import search  # search.engine imports obs

        exact = search.make("exact")
        state = exact.build(None, torch.as_tensor(corpus),
                            torch.as_tensor(R),
                            search.SearchConfig(tile_rows=tile_rows),
                            device=device)
        truth = exact.search(state, queries, k=k).ids
        return cls(queries, truth, k=k, every=every, name=name,
                   registry=registry)

    def _registry(self) -> reg_mod.Registry:
        return self.registry or reg_mod.default_registry()

    def run(self, search_fn: Callable) -> float:
        """Measure now: ``search_fn(queries)`` returns a SearchResult (or an
        ids array); the recall goes to ``last`` and the gauge."""
        reg = self._registry()
        with reg.span(f"{self.name}.replay"):
            res = search_fn(self.queries)
        ids = _host(getattr(res, "ids", res))
        recall = recall_at_k(ids, self.truth, self.k)
        self.last = recall
        reg.gauge(f"{self.name}.recall_at_k", k=self.k).set(recall)
        reg.counter(f"{self.name}.runs").inc()
        reg.event("recall_probe", name=self.name, k=self.k, recall=recall,
                  queries=int(self.queries.shape[0]))
        return recall

    def maybe_run(self, search_fn: Callable) -> float | None:
        """Sampling entry point: runs on every ``every``-th call (the first
        call measures at once, so a fresh serving loop has a baseline)."""
        due = self._since == 0
        self._since = (self._since + 1) % self.every
        if due:
            return self.run(search_fn)
        return None
