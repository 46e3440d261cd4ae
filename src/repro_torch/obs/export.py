"""Exporters: a JSONL event sink and a text snapshot report (port of the
part of ``repro/obs/export.py`` that the registry uses).

The JSONL log is the durable trail: one event per line, appended and
flushed on each write, so a run cut short leaves readable lines. Both
exporters read only the registry's public surface (``events`` and
``snapshot``), so the global registry and an Engine's private one export
the same way.
"""
from __future__ import annotations

import json
import math
from typing import Any

import numpy as np
import torch


def jsonable(x: Any) -> Any:
    """Recursively coerce to JSON-safe values: numpy and torch scalars and
    arrays become Python numbers and lists, non-finite floats become None
    (strict JSON has no NaN or Infinity), tuples and sets become lists."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        v = float(x)
        return v if math.isfinite(v) else None
    if isinstance(x, torch.Tensor):
        return jsonable(x.detach().cpu().tolist())
    if isinstance(x, np.ndarray):
        return jsonable(x.tolist())
    if x is None or isinstance(x, str):
        return x
    return str(x)


class JsonlSink:
    """Append-only JSONL event log: one registry event per line."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, rec: dict) -> None:
        self._fh.write(json.dumps(jsonable(rec), allow_nan=False) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def read_jsonl(path: str) -> list[dict]:
    """Every event of a JSONL log (the round trip of ``JsonlSink``)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def text_report(registry) -> str:
    """Fixed-width snapshot of every metric in the registry: counters and
    gauges one per line, distributions with their window percentiles."""
    snap = registry.snapshot()
    lines = []
    if snap["counters"]:
        lines.append("-- counters (lifetime) --")
        for name, v in sorted(snap["counters"].items()):
            lines.append(f"{name:<48} {v}")
    if snap["gauges"]:
        lines.append("-- gauges (last value) --")
        for name, v in sorted(snap["gauges"].items()):
            lines.append(f"{name:<48} {v:.6g}")
    if snap["distributions"]:
        lines.append("-- distributions (lifetime count; window percentiles) --")
        for name, s in sorted(snap["distributions"].items()):
            lines.append(
                f"{name:<48} n={s['count']} mean={s['mean']:.4g} "
                f"p50={s['p50']:.4g} p95={s['p95']:.4g} "
                f"p99={s['p99']:.4g} max={s['max']:.4g}")
    return "\n".join(lines) if lines else "(no metrics recorded)"
