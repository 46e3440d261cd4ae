"""repro_torch.serve — the multi-tenant serving front end over
``search.Engine`` (port of ``repro/serve``).

The Engine solves the single-index problems (shape buckets, executables,
the LUT cache, live refresh). This package adds the request scheduling
that production serving runs on:

  * ``queue``      — continuous-batching admission (deadline-driven
                     buckets, no fixed-batch stalls) and the
                     ``VirtualClock`` of deterministic simulations;
  * ``slo``        — per-request latency SLOs that pick nprobe from a
                     fixed ladder of warmed-up rungs;
  * ``namespaces`` — many named indexes behind one front end, with their
                     own caches and one shared host LUT budget;
  * ``frontend``   — the loop that ties them together: submit → poll →
                     completed tickets, churn maintenance ticked into idle
                     slots.

A serving session::

    from repro_torch import serve
    fe = serve.Frontend(slo_ms=50.0)
    fe.create_namespace("tenant-a", "ivf", state, nprobe_ladder=(4, 16, 32),
                        warmup_queries=Qtrain[:8])
    t = fe.submit("tenant-a", q_row)
    while not t.done:
        fe.poll()
    print(t.result.ids, t.latency_ms, t.nprobe_served)

The load generator and the SLO-adaptive against fixed comparison are
``repro_torch.bench.serve_load``.
"""
from repro_torch.serve.frontend import Frontend
from repro_torch.serve.namespaces import Namespace, NamespaceSet
from repro_torch.serve.queue import BatchQueue, Ticket, VirtualClock
from repro_torch.serve.slo import SLOController

__all__ = [
    "Frontend", "Namespace", "NamespaceSet", "BatchQueue", "Ticket",
    "VirtualClock", "SLOController",
]
