"""Continuous-batching admission queue: requests, tickets, deadlines (port
of ``repro/serve/queue.py``).

The Engine answers "here is a (b, n) batch"; production traffic is a
stream of single queries, each with its own latency budget.
``BatchQueue`` turns the stream back into Engine-shaped work without
fixed-batch stalls:

  * a request joins the current bucket the moment it arrives; there is no
    "wait for 32" barrier;
  * the bucket flushes when the oldest request's admission deadline
    (``admission_ms`` after its arrival) passes, or at once when the
    bucket is full (``max_admit`` requests, the Engine's ``max_bucket``).
    ``admission_ms = 0`` flushes on every poll;
  * a flush pads up to the Engine's next power-of-two bucket, so steady
    state reuses the Engine's per-(bucket, k, nprobe) executables.

Every timestamp comes from an injected ``clock()`` (seconds, monotonic):
``time.monotonic`` for wall-clock serving, a ``VirtualClock`` for
benchmarks and tests, whose queueing then needs no real sleeps.

One queue serves one namespace; the loop over namespaces is
``serve.frontend``. Pure Python: no tensor is made here, and a ticket's
``result`` is a row view of the batch's tensors on the state's device.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Callable, Iterator

from repro_torch.search.base import SearchResult

_rid = itertools.count()


class VirtualClock:
    """A manually advanced clock for deterministic serving simulations.

    ``now()`` plugs in wherever ``time.monotonic`` would; the load
    generator advances it by measured service times (open-loop virtual
    time over real compute). ``advance`` refuses negative steps and ``set``
    never moves backwards, so no latency can come out negative."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"cannot advance by {seconds}")
        self._t += seconds
        return self._t

    def set(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t


@dataclasses.dataclass
class Ticket:
    """One in-flight request: what was submitted and where it completes.

    ``result`` is this request's own row of the batch it was served in (a
    (k,)-shaped ``SearchResult`` of views on the batch's tensors).
    ``nprobe_served`` records what the SLO controller spent on it."""

    rid: int
    namespace: str
    query: Any                       # (n,) host row: the LUT cache's key
    k: int
    nprobe: int | None               # explicit override; None: SLO picks
    slo_ms: float
    arrival: float                   # clock() at submit
    completed: float | None = None   # clock() at collect
    result: SearchResult | None = None
    nprobe_served: int | None = None
    waited_ms: float = 0.0           # admission-queue wait at flush time

    @property
    def done(self) -> bool:
        return self.completed is not None

    @property
    def latency_ms(self) -> float:
        """End-to-end latency, arrival to result ready (queue wait plus
        batch service), in the ticket's clock domain."""
        if self.completed is None:
            raise ValueError(f"request {self.rid} still in flight")
        return (self.completed - self.arrival) * 1e3

    def remaining_ms(self, now: float) -> float:
        """What is left of the latency budget at ``now``; negative when the
        request is already late (it is then served at the floor rung)."""
        return self.slo_ms - (now - self.arrival) * 1e3


def make_ticket(namespace: str, query, *, k: int, nprobe: int | None,
                slo_ms: float, arrival: float) -> Ticket:
    return Ticket(rid=next(_rid), namespace=namespace, query=query, k=k,
                  nprobe=nprobe, slo_ms=slo_ms, arrival=arrival)


class BatchQueue:
    """Deadline-driven admission queue for one namespace (module doc).

    ``admission_ms`` is how long the oldest request may wait for
    co-riders before its bucket flushes: latency traded for batch size,
    apart from the per-request SLO that the nprobe controller spends.
    ``max_admit`` caps a flush at the Engine's ``max_bucket``, so a flush
    is always one ``Engine.submit``."""

    def __init__(self, *, admission_ms: float = 2.0, max_admit: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        if admission_ms < 0:
            raise ValueError(f"admission_ms must be >= 0, got {admission_ms}")
        if max_admit < 1:
            raise ValueError(f"max_admit must be >= 1, got {max_admit}")
        self.admission_ms = float(admission_ms)
        self.max_admit = int(max_admit)
        self.clock = clock
        self._pending: deque[Ticket] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, ticket: Ticket) -> None:
        self._pending.append(ticket)

    @property
    def depth(self) -> int:
        return len(self._pending)

    def next_deadline(self) -> float | None:
        """Clock time at which the current bucket must flush (None when
        empty). A full bucket is due at once."""
        if not self._pending:
            return None
        if len(self._pending) >= self.max_admit:
            return self._pending[0].arrival
        return self._pending[0].arrival + self.admission_ms * 1e-3

    def due(self, now: float | None = None) -> bool:
        deadline = self.next_deadline()
        if deadline is None:
            return False
        now = self.clock() if now is None else now
        return len(self._pending) >= self.max_admit or now >= deadline

    def _pop(self, now: float) -> list[Ticket]:
        batch = [self._pending.popleft()
                 for _ in range(min(len(self._pending), self.max_admit))]
        for t in batch:
            t.waited_ms = max(0.0, (now - t.arrival) * 1e3)
        return batch

    def take(self, now: float | None = None) -> list[Ticket]:
        """Pop the current bucket (up to ``max_admit`` tickets, FIFO) and
        stamp each ticket's queue wait; [] when nothing is due, so callers
        can loop ``while (batch := q.take()):``."""
        now = self.clock() if now is None else now
        if not self.due(now):
            return []
        return self._pop(now)

    def drain(self) -> Iterator[list[Ticket]]:
        """Yield every remaining bucket whatever the deadlines (shutdown,
        the end of a run)."""
        while self._pending:
            yield self._pop(self.clock())
