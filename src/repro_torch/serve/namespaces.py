"""Multi-tenant namespaces: many named indexes behind one front end (port
of ``repro/serve/namespaces.py``).

A namespace is one tenant's serving unit: its own Engine (any registry
backend), admission queue, SLO controller and, optionally,
ChurnController. Tenants share only what they must:

  * the device: batches of different namespaces interleave on it, all on
    its default stream (the stream the Engine's event and the churn
    worker assume);
  * the host LUT budget: ``NamespaceSet`` owns one ``lut_budget_rows`` pot
    and splits it evenly, writing each Engine's ``lut_cache_rows`` on
    every add and drop and trimming at once. A hot tenant evicts only its
    own cached tables (its ``lut_evictions``).

Isolation (pinned by ``tests/test_torch_serve.py``): a refresh on one
tenant never touches another's LUT cache or epoch (each Engine has its
own ``_luts``/``_epoch``), executables are per Engine, and so are the obs
registries; the front end aggregates views and merges no state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.search.engine import Engine
from repro_torch.serve.queue import BatchQueue
from repro_torch.serve.slo import SLOController


@dataclasses.dataclass
class Namespace:
    """One tenant: engine, queue and nprobe controller (and churn)."""

    name: str
    engine: Engine
    queue: BatchQueue
    slo: SLOController
    churn: Any | None = None          # ChurnController, when churn-enabled
    slo_ms: float = 50.0              # default per-request latency budget
    adaptive: bool = False            # the SLO controller picks the rung
    warm_compiles: int = 0            # executables made by warmup

    def maintenance_tick(self) -> bool:
        """One idle-slot churn step (a flush or compaction where a
        threshold is crossed, else nothing). Returns whether this
        namespace had a controller to tick."""
        if self.churn is None:
            return False
        self.churn.step()
        return True

    def stats(self) -> dict:
        s = self.engine.stats()
        s["queue_depth"] = self.queue.depth
        s["slo"] = self.slo.stats()
        return s


class NamespaceSet:
    """The tenant table and the shared host LUT budget.

    ``lut_budget_rows`` is the total across tenants, in the unit of
    ``Engine.lut_cache_rows`` (cached per-query table rows). Every add and
    drop splits it evenly again and trims each Engine, so the bound holds
    whatever the tenant count."""

    def __init__(self, *, lut_budget_rows: int = 8192):
        if lut_budget_rows < 0:
            raise ValueError(f"lut_budget_rows must be >= 0, "
                             f"got {lut_budget_rows}")
        self.lut_budget_rows = int(lut_budget_rows)
        self._spaces: dict[str, Namespace] = {}

    def __len__(self) -> int:
        return len(self._spaces)

    def __iter__(self):
        return iter(self._spaces.values())

    def __contains__(self, name: str) -> bool:
        return name in self._spaces

    def get(self, name: str) -> Namespace:
        try:
            return self._spaces[name]
        except KeyError:
            raise KeyError(
                f"unknown namespace {name!r}; have {sorted(self._spaces)}"
            ) from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._spaces)

    def _resplit(self) -> None:
        """Even split of the budget; each Engine trims to its new cap at
        once (and counts its evictions)."""
        if not self._spaces:
            return
        share = self.lut_budget_rows // len(self._spaces)
        for ns in self._spaces.values():
            ns.engine.lut_cache_rows = share
            ns.engine._evict()

    def add(self, ns: Namespace) -> Namespace:
        if ns.name in self._spaces:
            raise ValueError(f"namespace {ns.name!r} already exists")
        self._spaces[ns.name] = ns
        self._resplit()
        return ns

    def drop(self, name: str) -> None:
        self.get(name)          # the uniform KeyError on an unknown name
        del self._spaces[name]
        self._resplit()
