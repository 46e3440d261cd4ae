"""LiveIndexLoop: trainer → live index, without a rebuild (port of
``repro/pipeline/loop.py``).

The glue between ``make_train_step(emit_deltas=True)`` and a serving
``search.Engine``. Each training step's manifold update already computes
the exact ``RotationDelta`` it applied to R; this loop buffers them and,
every ``refresh_every`` steps, replays them onto the live index through
``Engine.refresh``: a state swap at unchanged shapes under the Engine's
executables, so keeping the index aligned with the trainer makes no new
executable and no rebuild.

Freshness: the eager refresh drops cross-subspace angles when it absorbs
a delta into product codebooks (``maintain.refresh_delta``), so each
applied delta leaves the stored codes a little further from a fresh
encode. Every refresh round bumps the ``StalenessTracker``'s epoch, and
the attached ``BackgroundCompactor`` re-encodes the stalest rows inside
its next pass, off the training thread.

One thread drives it: call ``on_step(metrics)`` from the training loop
after each step. The only work on that thread is the refresh and a
non-blocking poll or submit of the compactor.
"""
from __future__ import annotations

from repro_torch import obs


class LiveIndexLoop:
    """Drive a live Engine from per-step rotation deltas (module
    docstring).

    ``delta_key`` names the manifold leaf in ``metrics["rotation_deltas"]``
    that rotates the index (the trainer may carry others, e.g. KV-cache
    rotations). ``compact_every`` counts refresh rounds between compaction
    submits (0: never submit; the caller owns compaction).
    """

    def __init__(self, engine, *, delta_key: str = "R",
                 refresh_every: int = 8, tracker=None, compactor=None,
                 compact_every: int = 4, registry=None):
        self.engine = engine
        self.delta_key = delta_key
        self.refresh_every = max(1, int(refresh_every))
        self.tracker = tracker
        self.compactor = compactor
        self.compact_every = int(compact_every)
        self.obs = (registry if registry is not None
                    else getattr(engine, "obs", None)
                    or obs.default_registry())
        self._buffer: list = []
        self._steps = 0
        self._rounds = 0

    def on_step(self, metrics: dict) -> None:
        """Take one training step's metrics: buffer its delta, refresh on
        cadence, keep the background compactor moving."""
        self._steps += 1
        deltas = metrics.get("rotation_deltas")
        if deltas is not None:
            if self.delta_key not in deltas:
                # a miss would otherwise be a silent no-op for the whole
                # run: the trainer emits the same leaves every step
                raise KeyError(
                    f"LiveIndexLoop: delta_key {self.delta_key!r} not in "
                    f"emitted rotation deltas {sorted(deltas)}; pass "
                    f"delta_key= matching the trainer's manifold leaf")
            self._buffer.append(deltas[self.delta_key])
        if self.compactor is not None:
            self.compactor.poll()
        if self._steps % self.refresh_every == 0:
            self.flush_refresh()

    def flush_refresh(self) -> int:
        """Apply every buffered delta to the live index, in step order, and
        return how many. Bumps the staleness epoch once per delta and
        submits a background compaction every ``compact_every`` rounds."""
        applied = len(self._buffer)
        if applied:
            with self.obs.span("pipeline.refresh") as sp:
                for delta in self._buffer:
                    self.engine.refresh(delta)
                sp.sync(self.engine.state)
            self._buffer.clear()
            if self.tracker is not None:
                self.tracker.bump(applied)
            self.obs.counter("pipeline.refreshes").inc()
            self.obs.counter("pipeline.deltas_applied").inc(applied)
            self._rounds += 1
            if (self.compactor is not None and self.compact_every > 0
                    and self._rounds % self.compact_every == 0):
                self.compactor.submit()
        return applied

    def drain(self) -> None:
        """End of training: apply the stragglers and land the last
        compaction pass (join, then poll, which swaps)."""
        self.flush_refresh()
        if self.compactor is not None:
            self.compactor.join()
            self.compactor.poll()

    def stats(self) -> dict:
        return dict(
            steps=self._steps,
            refresh_rounds=self._rounds,
            buffered=len(self._buffer),
            refreshes=self.obs.counter("pipeline.refreshes").value,
            deltas_applied=self.obs.counter(
                "pipeline.deltas_applied").value,
            staleness_epoch=(self.tracker.epoch
                             if self.tracker is not None else 0),
            tracked_rows=(len(self.tracker)
                          if self.tracker is not None else 0),
        )
