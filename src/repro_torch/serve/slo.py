"""SLO-adaptive nprobe: a feedback controller over measured latencies (port
of ``repro/serve/slo.py``).

``nprobe`` is the serving-time dial between recall and latency: more
probed IVF lists, more recall and proportionally more scan work.
``SLOController`` closes the loop:

  * it picks only from a small fixed **ladder** of rungs, the set the
    front end warms up, so adaptation never makes a new Engine executable
    (the Engine keys them on (bucket, k, nprobe));
  * per (bucket, rung) it keeps an EWMA of measured batch service time,
    seeded by warmup and updated by every served batch (``observe``);
  * ``choose`` picks the highest rung whose prediction, inflated by a
    safety margin and by the backlog queued behind the batch (each wave
    of backlog adds one service time of queueing), fits the remaining
    budget: the top rung under light load, shedding toward the floor
    under a burst.

Pure arithmetic with no tensor and no thread: the same observations give
the JAX controller's decisions exactly.
"""
from __future__ import annotations

import math


class SLOController:
    """Pick an nprobe rung for each flush so requests meet their SLO.

    ``ladder``: nprobe rungs (sorted here; the only values returned).
    ``safety``: multiplier on the prediction before it is compared with
    the budget. ``ewma``: weight of a new observation."""

    def __init__(self, ladder=(4, 16, 32), *, safety: float = 1.3,
                 ewma: float = 0.3):
        if not ladder:
            raise ValueError("nprobe ladder must be non-empty")
        self.ladder = tuple(sorted(int(r) for r in ladder))
        if self.ladder[0] < 1:
            raise ValueError(f"nprobe rungs must be >= 1, got {self.ladder}")
        if not 0 < ewma <= 1:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.safety = float(safety)
        self.ewma = float(ewma)
        self._lat_ms: dict[tuple[int, int], float] = {}  # (bucket, rung)
        self.decisions = 0
        self.sheds = 0          # picked below the top rung
        self.floors = 0         # nothing fit the budget: served at the floor

    def predict_ms(self, bucket: int, rung: int) -> float | None:
        """The latency estimate of one (bucket, rung) batch, or None before
        any observation."""
        return self._lat_ms.get((bucket, rung))

    def observe(self, bucket: int, rung: int, latency_ms: float) -> None:
        """Fold one measured batch service time into the EWMA (a
        non-finite or negative time is dropped)."""
        if not math.isfinite(latency_ms) or latency_ms < 0:
            return
        key = (int(bucket), int(rung))
        prev = self._lat_ms.get(key)
        if prev is None:
            self._lat_ms[key] = float(latency_ms)
        else:
            self._lat_ms[key] = (1 - self.ewma) * prev + self.ewma * latency_ms

    def choose(self, budget_ms: float, bucket: int, backlog: int = 0) -> int:
        """The highest rung predicted to fit ``budget_ms`` for a
        ``bucket``-row batch with ``backlog`` requests queued behind it.

        The prediction is inflated by (1 + backlog / bucket) waves, so the
        controller sheds before the queueing shows in measured latencies.
        A cell with no EWMA yet counts as not fitting, except the floor
        rung, which is always allowed."""
        self.decisions += 1
        waves = 1.0 + max(0, int(backlog)) / max(1, int(bucket))
        for rung in reversed(self.ladder):
            pred = self._lat_ms.get((int(bucket), rung))
            if pred is not None and pred * self.safety * waves <= budget_ms:
                if rung != self.ladder[-1]:
                    self.sheds += 1
                return rung
        self.floors += 1
        self.sheds += 1
        return self.ladder[0]

    def stats(self) -> dict:
        return {
            "ladder": self.ladder,
            "decisions": self.decisions,
            "sheds": self.sheds,
            "floors": self.floors,
            "cells": {f"b{b}/np{r}": round(v, 4)
                      for (b, r), v in sorted(self._lat_ms.items())},
        }
