"""Process-local metrics registry: counters, gauges, distributions, spans
(port of ``repro/obs/registry.py``).

Three rules:

  * **near-free when disabled**: a disabled registry hands out shared null
    objects; no metric is created, no event kept, no device synchronised.
  * **host-side only**: a span that times device work names the tensors
    to wait for with ``sync``; at exit it calls ``torch.cuda.synchronize``
    on the device of every CUDA tensor it was given, so work launched
    asynchronously is charged to the span that launched it.
  * **windows vs lifetimes**: counters and gauges are lifetime values;
    distributions keep lifetime count/sum/min/max and a bounded window
    that the percentiles (p50/p95/p99) are taken over.

Spans nest: the recorded name is the dotted path of the enclosing spans
(``engine.search`` inside ``serve`` records ``serve.engine.search``), the
stack is per thread, and an exception inside a span still records its time
(with ``error=True``) and propagates. With ``profile=True`` each span also
enters ``torch.profiler.record_function`` under its path, so host spans
line up with the card's kernels in a profiler trace; ``trace(dir)`` runs
``torch.profiler.profile`` over a block and writes a Chrome trace there.

Metric creation is locked, so threads that instrument the same name share
one object; writers of one metric stay single-threaded by convention.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Any, Iterator

import torch

MetricKey = tuple[str, tuple[tuple[str, Any], ...]]


def _key(name: str, labels: dict[str, Any]) -> MetricKey:
    return (name, tuple(sorted(labels.items())))


def _label_str(name: str, labels: tuple[tuple[str, Any], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic lifetime count (requests served, compiles, cache hits)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple[tuple[str, Any], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last written value (live recall, orthogonality drift)."""

    __slots__ = ("name", "labels", "value", "updates")

    def __init__(self, name: str, labels: tuple[tuple[str, Any], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.updates = 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.updates += 1


class Distribution:
    """Lifetime count/sum/min/max and a bounded window of samples for the
    percentiles. ``summary()`` says which aggregate is which."""

    __slots__ = ("name", "labels", "count", "total", "min", "max", "_window")

    def __init__(self, name: str, labels: tuple[tuple[str, Any], ...] = (),
                 window: int = 1024):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window: collections.deque[float] = collections.deque(
            maxlen=max(1, window))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._window.append(v)

    def window_values(self) -> list[float]:
        return list(self._window)

    def percentile(self, q: float) -> float:
        """Linearly interpolated percentile over the window."""
        w = sorted(self._window)
        if not w:
            return 0.0
        pos = (q / 100.0) * (len(w) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(w) - 1)
        frac = pos - lo
        return w[lo] * (1.0 - frac) + w[hi] * frac

    def summary(self) -> dict:
        w = list(self._window)
        return dict(
            count=self.count,                       # lifetime
            total=self.total,                       # lifetime
            min=self.min if self.count else 0.0,    # lifetime
            max=self.max if self.count else 0.0,    # lifetime
            window=len(w),
            mean=(sum(w) / len(w)) if w else 0.0,   # window-scoped ↓
            p50=self.percentile(50.0),
            p95=self.percentile(95.0),
            p99=self.percentile(99.0),
        )


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry."""

    __slots__ = ()
    value = 0
    updates = 0
    count = 0
    total = 0.0

    def inc(self, n: int | float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def window_values(self) -> list[float]:
        return []

    def summary(self) -> dict:
        return {}


_NULL_METRIC = _NullMetric()


class _NullSpan:
    """No-op span (stateless, so one shared instance nests safely)."""

    __slots__ = ()
    elapsed_ms = 0.0
    path = ""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def sync(self, value):
        return value


_NULL_SPAN = _NullSpan()


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value``: tensors, containers,
    named tuples and dataclasses, walked recursively."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


def synchronize(value) -> None:
    """Wait for the card's work on every CUDA tensor in ``value`` (a no-op
    for CPU tensors and plain values)."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)


class Span:
    """Timing span: records a ``span.<path>.ms`` distribution and one event.

    ``sync(value)`` names tensors the span must wait for before it stops
    the clock. Exception-safe: the time is recorded either way, with
    ``error=True`` on the failure path, and the exception propagates.
    """

    __slots__ = ("_registry", "name", "path", "_t0", "_pending",
                 "elapsed_ms", "_annotation")

    def __init__(self, registry: "Registry", name: str):
        self._registry = registry
        self.name = name
        self.path = name
        self._t0 = 0.0
        self._pending: list = []
        self.elapsed_ms = 0.0
        self._annotation = None

    def sync(self, value):
        """Register ``value`` (tensors, in any container) to wait for at
        span exit. Returns it unchanged."""
        self._pending.append(value)
        return value

    def __enter__(self) -> "Span":
        stack = self._registry._span_stack()
        self.path = ".".join([*stack, self.name]) if stack else self.name
        stack.append(self.name)
        if self._registry.profile:
            self._annotation = torch.profiler.record_function(self.path)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self._pending:
                synchronize(self._pending)
        finally:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
            if self._annotation is not None:
                self._annotation.__exit__(exc_type, exc, tb)
            stack = self._registry._span_stack()
            if stack and stack[-1] == self.name:
                stack.pop()
            self._registry.distribution(
                f"span.{self.path}.ms").observe(self.elapsed_ms)
            self._registry.event(
                "span", name=self.path, ms=self.elapsed_ms,
                error=exc_type is not None)
        return False


class Registry:
    """One process-local metrics namespace (see the module docstring).

    ``window`` bounds the distributions' sample windows and the per-kind
    event windows; ``profile=True`` forwards spans to
    ``torch.profiler.record_function``.
    """

    def __init__(self, *, enabled: bool = True, window: int = 1024,
                 profile: bool = False):
        self.enabled = enabled
        self.window = max(1, window)
        self.profile = profile
        self._metrics: dict[MetricKey, Any] = {}
        self._events: dict[str, collections.deque] = {}
        self._sinks: list = []
        self._local = threading.local()
        self._create_lock = threading.Lock()

    # -- metric accessors (get-or-create) ----------------------------------
    def _get(self, cls, name: str, labels: dict, **kw):
        if not self.enabled:
            return _NULL_METRIC
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._create_lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def distribution(self, name: str, **labels) -> Distribution:
        return self._get(Distribution, name, labels, window=self.window)

    # -- spans --------------------------------------------------------------
    def _span_stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def span(self, name: str) -> Span | _NullSpan:
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name)

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """``torch.profiler.profile`` of the block, written as a Chrome
        trace into ``log_dir``, when profiling is on; a no-op otherwise."""
        if not (self.enabled and self.profile):
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    # -- events -------------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Append one structured event (bounded per-kind window) and fan it
        out to the attached sinks (JSONL)."""
        if not self.enabled:
            return
        rec = {"kind": kind, "t": time.time(), **fields}
        win = self._events.get(kind)
        if win is None:
            with self._create_lock:
                win = self._events.get(kind)
                if win is None:
                    win = collections.deque(maxlen=self.window)
                    self._events[kind] = win
        win.append(rec)
        for sink in self._sinks:
            sink.write(rec)

    def events(self, kind: str | None = None) -> list[dict]:
        if kind is not None:
            return list(self._events.get(kind, ()))
        return [r for win in self._events.values() for r in win]

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    # -- inspection ---------------------------------------------------------
    def metrics(self) -> Iterator[Any]:
        return iter(self._metrics.values())

    def snapshot(self) -> dict:
        """Nested plain-dict view: counters and gauges as values,
        distributions as ``summary()`` dicts."""
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "distributions": {}}
        for m in self._metrics.values():
            label = _label_str(m.name, m.labels)
            if isinstance(m, Counter):
                out["counters"][label] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][label] = m.value
            else:
                out["distributions"][label] = m.summary()
        return out

    def reset(self) -> None:
        """Drop every metric, event window and sink (closing the sinks)."""
        self._metrics.clear()
        self._events.clear()
        for sink in self._sinks:
            close = getattr(sink, "close", None)
            if close:
                close()
        self._sinks.clear()


# ---------------------------------------------------------------------------
# The global default registry: disabled until someone asks to watch.
# ---------------------------------------------------------------------------

_default = Registry(enabled=False)


def default_registry() -> Registry:
    return _default


def enabled() -> bool:
    return _default.enabled


def enable(*, jsonl: str | None = None, profile: bool = False) -> Registry:
    """Turn the global registry on, optionally with a JSONL event log and
    span forwarding to ``torch.profiler``."""
    _default.enabled = True
    _default.profile = profile
    if jsonl is not None:
        from repro_torch.obs.export import JsonlSink

        _default.add_sink(JsonlSink(jsonl))
    return _default


def disable() -> None:
    _default.enabled = False


@contextlib.contextmanager
def override(enabled_: bool = True):
    """Flip the global registry's enabled flag for the block."""
    prev = _default.enabled
    _default.enabled = enabled_
    try:
        yield _default
    finally:
        _default.enabled = prev


# Conveniences over the default registry: library code calls these, so one
# ``obs.enable()`` turns everything on.
def counter(name: str, **labels) -> Counter:
    return _default.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _default.gauge(name, **labels)


def distribution(name: str, **labels) -> Distribution:
    return _default.distribution(name, **labels)


def span(name: str) -> Span | _NullSpan:
    return _default.span(name)


def event(kind: str, **fields) -> None:
    _default.event(kind, **fields)
