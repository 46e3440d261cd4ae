"""Observability (port of ``repro/obs``): metrics, spans, exporters and the
recall probe.

  * **registry** (``Registry``, ``counter``, ``gauge``, ``distribution``):
    process-local metrics with window percentiles. The global registry is
    disabled until ``obs.enable()``, and disabled instrumentation costs a
    lookup and a no-op call.
  * **spans** (``span``): nested, exception-safe timing blocks that can
    ``sync`` on CUDA tensors and forward to
    ``torch.profiler.record_function`` with ``profile=True``.
  * **exporters**: the JSONL event log (``enable(jsonl=...)``) and the
    text snapshot (``report``).
  * **probes** (``RecallProbe``): pinned-query recall@k replayed through
    the serving path, so a bad refresh shows as lower recall.

``search.Engine`` records its requests on a private, always-on registry
behind ``stats()``; ``index.maintain.refresh_health`` records the delta
norm and the orthogonality drift on the global one. The BENCH trajectory
writer (``obs/bench.py``) waits for a later slice (ROADMAP.md queue 10).
"""
from repro_torch.obs.export import (  # noqa: F401
    JsonlSink,
    jsonable,
    read_jsonl,
    text_report,
)
from repro_torch.obs.probe import RecallProbe  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Distribution,
    Gauge,
    Registry,
    Span,
    counter,
    default_registry,
    disable,
    distribution,
    enable,
    enabled,
    event,
    gauge,
    override,
    span,
)


def report(registry: Registry | None = None) -> str:
    """Text snapshot of ``registry`` (default: the global registry)."""
    return text_report(registry if registry is not None
                       else default_registry())
