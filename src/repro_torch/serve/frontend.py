"""The serving front end: one loop over many tenants (port of
``repro/serve/frontend.py``).

``Frontend`` owns the namespace table. Callers ``submit`` single queries,
each with its own latency SLO, and ``poll`` does the rest:

  1. **flush due buckets**: every namespace whose admission deadline has
     passed (or whose bucket is full) has its tickets popped, grouped by
     (k, nprobe) into Engine batches and submitted; the groups are then
     collected in order and each ticket gets its own row of its batch;
  2. **pick nprobe**: a ticket without an explicit nprobe is served at the
     rung its namespace's ``SLOController`` picks from the remaining
     budget and the backlog, from a fixed warmed-up ladder;
  3. **idle maintenance**: a poll that flushed nothing ticks one
     namespace's ``ChurnController`` instead (round robin), so flushes
     and compactions run between buckets on the serving thread.

``create_namespace`` attaches the ChurnController before warmup, because
installing the staging buffer changes the state's structure (and widens
its probe window): the one structural change, made before the first
executable. Warmup then serves every (bucket ≤ max_admit, k, rung) cell
once untimed and three times timed, and seeds the SLO model with the
median, so serving starts calibrated and with every executable made.

The front end creates no tensor: the states it is given decide the
device. On the card every namespace serves on the device's default
stream. A flush's groups overlap less than the JAX package's: the IVF
submit reads the candidate width to the host once a batch and the LUT
cache copies missed tables to the host (``search/engine.py``). Results
stay on the device: a ticket's ``result`` is a row view of its batch's
tensors, and no copy to the host enters the measured service time.
``Engine.collect`` waits on the batch's CUDA event, so
``perf_counter() − pending.t0`` is the card's real service time.

Clocks: ``clock=time.monotonic`` (the default) serves in wall-clock time;
a ``VirtualClock``'s ``now``/``advance`` pair runs a deterministic
simulation in which queueing is virtual and service time is measured
(``repro_torch.bench.serve_load``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch import search as search_registry
from repro_torch.search.base import SearchResult
from repro_torch.search.engine import Engine
from repro_torch.serve.namespaces import Namespace, NamespaceSet
from repro_torch.serve.queue import BatchQueue, Ticket, make_ticket
from repro_torch.serve.slo import SLOController

_ADAPTIVE = object()     # grouping key slot for "the SLO picks the rung"


def _synth_warmup_queries(state: Any, rows: int = 8) -> np.ndarray:
    """Gaussian (rows, n) warmup queries at the state's rotation width, the
    JAX package's bytes (numpy, seed 0).

    Warmup makes cells and times them, and a cell's cost does not depend
    on the queries' values. The rotation is found as ``Engine.refresh``
    finds it (``state.rot``, else ``state.R``, else ``state.index.R``); a
    state with none gets no default warmup."""
    R = getattr(state, "rot", None)
    if R is None:
        R = getattr(state, "R", None)
    if R is None:
        R = getattr(getattr(state, "index", None), "R", None)
    if R is None:
        return np.empty((0, 0), dtype=np.float32)
    n = int(R.shape[-1])
    return np.random.default_rng(0).standard_normal((rows, n)).astype(
        np.float32)


class Frontend:
    """Multi-tenant continuous-batching serving loop (module doc).

    ``lut_budget_rows`` is the host LUT budget all namespaces share (split
    evenly, ``serve.namespaces``); ``slo_ms`` the default per-request
    budget, which each submit may override."""

    def __init__(self, *, lut_budget_rows: int = 8192, slo_ms: float = 50.0,
                 clock: Callable[[], float] = time.monotonic,
                 advance: Callable[[float], float] | None = None):
        self.namespaces = NamespaceSet(lut_budget_rows=lut_budget_rows)
        self.default_slo_ms = float(slo_ms)
        self.clock = clock
        self._advance = advance      # virtual-time hook; None: wall clock
        self._tick_order: list[str] = []   # round-robin churn cursor
        self.obs = obs.Registry(enabled=True, window=512)
        self._counters = {
            name: self.obs.counter(f"serve.{name}")
            for name in ("admitted", "flushes", "batches", "served",
                         "sheds", "maintenance_ticks")}

    # -- tenant lifecycle --------------------------------------------------
    def create_namespace(self, name: str, searcher, state: Any = None, *,
                         k: int = 10,
                         nprobe_ladder: Sequence[int] | None = None,
                         slo_ms: float | None = None,
                         admission_ms: float = 2.0, max_admit: int = 64,
                         churn: dict | None = None,
                         warmup_queries: Any = None,
                         slo_safety: float = 1.3,
                         engine_kwargs: dict | None = None) -> Namespace:
        """Register a tenant. ``searcher`` is a registry spec string
        (``repro_torch.search.make``) or a Searcher; ``state`` is built by
        the caller and is never written.

        ``nprobe_ladder``: the rungs the SLO controller picks from (None:
        the Engine's default nprobe, no adaptation; required for backends
        without nprobe). ``churn``: keyword arguments of a
        ChurnController (e.g. ``{"staging_rows": 1024}``), attached
        before warmup; None: no churn. ``warmup_queries`` (m, n): rows
        tiled to make every (bucket, k, rung) cell and seed the SLO model;
        None synthesizes Gaussian rows at the state's rotation width;
        ``()`` skips warmup (the first requests then make the cells, and
        the controller serves at the floor until it has seen each)."""
        if isinstance(searcher, str):
            searcher = search_registry.make(searcher)
        kwargs = dict(engine_kwargs or {})
        kwargs.setdefault("max_bucket", max(max_admit, 1))
        engine = Engine(searcher, state, k=k, **kwargs)
        if nprobe_ladder is not None and not engine._takes_nprobe:
            raise ValueError(
                f"{type(searcher).__name__} does not take nprobe — "
                "nprobe_ladder requires an nprobe-capable backend")
        controller = None
        if churn is not None:
            # the staging install changes the state's structure: before
            # the first executable, hence before warmup
            from repro_torch.churn.controller import ChurnController
            controller = ChurnController(engine, **churn)
        ns = Namespace(
            name=name, engine=engine,
            queue=BatchQueue(admission_ms=admission_ms, max_admit=max_admit,
                             clock=self.clock),
            slo=SLOController(nprobe_ladder or (1,), safety=slo_safety),
            churn=controller)
        ns.slo_ms = self.default_slo_ms if slo_ms is None else float(slo_ms)
        ns.adaptive = nprobe_ladder is not None
        self.namespaces.add(ns)
        self._tick_order.append(name)
        if warmup_queries is None:
            warmup_queries = _synth_warmup_queries(state)
        Qw = np.asarray(warmup_queries)
        if Qw.size:
            self._warmup(ns, Qw)
        ns.warm_compiles = engine.stats()["compiles"]
        return ns

    def drop_namespace(self, name: str) -> None:
        self.namespaces.drop(name)
        self._tick_order.remove(name)

    def _warmup(self, ns: Namespace, Qw: np.ndarray) -> None:
        """Make every (bucket, k, rung) cell the queue can produce, and seed
        the SLO EWMA from three more timed runs of each (the first run pays
        the cell's first use and must not poison the model)."""
        engine = ns.engine
        buckets, b = [], engine.min_bucket
        top = min(max(ns.queue.max_admit, 1), engine.max_bucket)
        while True:
            buckets.append(b)
            if b >= top:
                break
            b *= 2
        rungs = list(ns.slo.ladder) if ns.adaptive else [None]
        for bucket in buckets:
            reps = -(-bucket // Qw.shape[0])
            Qb = np.tile(Qw, (reps, 1))[:bucket]
            for rung in rungs:
                engine.collect(engine.submit(Qb, nprobe=rung))   # first use
                reps_ms = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    engine.collect(engine.submit(Qb, nprobe=rung))
                    reps_ms.append((time.perf_counter() - t0) * 1e3)
                if rung is not None:
                    # the median of 3: one noisy sample must not skew the
                    # seed the controller (and rate calibration) trusts
                    ns.slo.observe(bucket, rung, sorted(reps_ms)[1])

    # -- request path ------------------------------------------------------
    def submit(self, namespace: str, query, *, k: int | None = None,
               nprobe: int | None = None, slo_ms: float | None = None,
               arrival: float | None = None) -> Ticket:
        """Admit one (n,) host query row into its namespace's current bucket
        and return the Ticket to wait on (``poll`` serves it).

        ``arrival`` backdates the ticket: an open-loop load generator
        submits the arrivals it finds when the loop gets control back, and
        their wait counts from when they arrived."""
        ns = self.namespaces.get(namespace)
        row = np.asarray(query)
        if row.ndim != 1:
            raise ValueError(
                f"submit takes one (n,) query row, got shape {row.shape}")
        t = make_ticket(
            ns.name, row, k=ns.engine.k if k is None else int(k),
            nprobe=nprobe,
            slo_ms=ns.slo_ms if slo_ms is None else float(slo_ms),
            arrival=self.clock() if arrival is None else float(arrival))
        ns.queue.push(t)
        self._counters["admitted"].inc()
        return t

    def next_deadline(self) -> float | None:
        """The earliest flush deadline over all namespaces (None when every
        queue is empty): what an event loop sleeps until."""
        deadlines = [d for ns in self.namespaces
                     if (d := ns.queue.next_deadline()) is not None]
        return min(deadlines) if deadlines else None

    def poll(self) -> list[Ticket]:
        """One turn of the loop: flush every due bucket; when nothing was
        due, one idle-slot churn tick instead. Returns the completed
        tickets."""
        done: list[Ticket] = []
        for ns in self.namespaces:
            while (batch := ns.queue.take(self.clock())):
                done.extend(self._serve(ns, batch))
            self.obs.gauge(f"serve.queue_depth.{ns.name}").set(ns.queue.depth)
        if not done:
            self._maintenance_tick()
        return done

    def drain(self) -> list[Ticket]:
        """Serve every namespace's remaining tickets whatever the deadlines
        (the end of a run, shutdown)."""
        done: list[Ticket] = []
        for ns in self.namespaces:
            for batch in ns.queue.drain():
                done.extend(self._serve(ns, batch))
        return done

    def _maintenance_tick(self) -> None:
        """Round-robin one namespace's churn step into this idle slot."""
        for _ in range(len(self._tick_order)):
            name = self._tick_order.pop(0)
            self._tick_order.append(name)
            if name in self.namespaces and \
                    self.namespaces.get(name).maintenance_tick():
                self._counters["maintenance_ticks"].inc()
                return

    # -- batch service -----------------------------------------------------
    def _serve(self, ns: Namespace, batch: list[Ticket]) -> list[Ticket]:
        """Serve one flushed bucket: group by (k, nprobe), pick the adaptive
        groups' rungs, submit every group, then collect them in order and
        hand each ticket its row."""
        self._counters["flushes"].inc()
        now = self.clock()
        groups: dict[tuple, list[Ticket]] = {}
        for t in batch:
            key = (t.k, t.nprobe if t.nprobe is not None
                   else (_ADAPTIVE if ns.adaptive else None))
            groups.setdefault(key, []).append(t)

        inflight = []
        for (k, npkey), tickets in groups.items():
            rung = None
            if npkey is _ADAPTIVE:
                budget = min(t.remaining_ms(now) for t in tickets)
                bucket = ns.engine._bucket(len(tickets))
                rung = ns.slo.choose(budget, bucket, backlog=ns.queue.depth)
                if rung != ns.slo.ladder[-1]:
                    self._counters["sheds"].inc()
                npb = rung
            else:
                npb = npkey
            Q = np.stack([t.query for t in tickets])
            pending = ns.engine.submit(Q, k=k, nprobe=npb)
            inflight.append((tickets, pending, rung))
            self._counters["batches"].inc()

        done = []
        for tickets, pending, rung in inflight:
            res = ns.engine.collect(pending)
            service_ms = (time.perf_counter() - pending.t0) * 1e3
            if self._advance is not None:
                # virtual time: the queueing already passed on the virtual
                # clock; the measured service time is folded in now
                self._advance(service_ms * 1e-3)
            completed = self.clock()
            if rung is not None:
                ns.slo.observe(pending.bucket, rung, service_ms)
            for i, t in enumerate(tickets):
                t.result = SearchResult(scores=res.scores[i], ids=res.ids[i],
                                        scanned=res.scanned[i])
                t.nprobe_served = pending.nprobe
                t.completed = completed
                done.append(t)
            self._counters["served"].inc(len(tickets))
        return done

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """The front end's counters and each namespace's engine, queue and
        SLO views."""
        out = {name: c.value for name, c in self._counters.items()}
        out["namespaces"] = {ns.name: ns.stats() for ns in self.namespaces}
        return out
