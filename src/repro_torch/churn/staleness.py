"""Per-row staleness: the rotation epoch each row was encoded at (a copy
of ``repro/churn/staleness.py``, which is plain numpy).

``stage`` encodes against the state's frozen quantizers, and the eager
refresh drops cross-subspace angles when it absorbs a delta into the
codebooks (``maintain.refresh_delta``), so every refresh leaves a row's
stored code a little further from what a fresh encode under the current
rotation would give (``maintain.drifted_ids`` is the ground truth).
Rebuilding on every refresh would undo the paper's cheap update; instead
this tracker records the epoch each row was last encoded at, and each
compaction pass re-encodes only the stalest rows
(``ops.compact(..., reencode=...)``).

Host-side and O(rows) in plain numpy. One writer: the poll or training
thread makes every mutation; the background compactor only reads what
``submit`` took under its lock.
"""
from __future__ import annotations

import numpy as np


class StalenessTracker:
    """Maps row id → rotation epoch at last encode (see module docstring)."""

    def __init__(self, ids=None, epoch: int = 0):
        self.epoch = int(epoch)
        self._encoded_at: dict[int, int] = {}
        if ids is not None:
            self.record(ids)

    def bump(self, n: int = 1) -> int:
        """A rotation delta landed: everything already encoded is now one
        epoch staler. Returns the new epoch."""
        self.epoch += int(n)
        return self.epoch

    def record(self, ids, epoch: int | None = None) -> None:
        """Rows were (re-)encoded at ``epoch`` (default: the current one)."""
        at = self.epoch if epoch is None else int(epoch)
        for i in np.asarray(ids, dtype=np.int64).ravel():
            if i >= 0:
                self._encoded_at[int(i)] = at

    def forget(self, ids) -> None:
        """Rows were tombstoned — stop tracking them."""
        for i in np.asarray(ids, dtype=np.int64).ravel():
            self._encoded_at.pop(int(i), None)

    def staleness_of(self, row_id: int) -> int:
        """Epochs since this row was encoded (0 = fresh/untracked)."""
        at = self._encoded_at.get(int(row_id))
        return 0 if at is None else self.epoch - at

    def stalest(self, k: int, *, min_staleness: int = 1) -> np.ndarray:
        """Ids of the ≤k stalest rows at least ``min_staleness`` epochs old
        — the re-encode batch for the next compaction pass. Ties broken by
        id for determinism."""
        cands = [(self.epoch - at, -i) for i, at in self._encoded_at.items()
                 if self.epoch - at >= min_staleness]
        if not cands:
            return np.empty(0, dtype=np.int64)
        cands.sort(reverse=True)
        return np.asarray([-neg for _, neg in cands[:k]], dtype=np.int64)

    def histogram(self, registry=None) -> dict[int, int]:
        """``{staleness: row count}``; optionally recorded onto an obs
        registry as the ``churn.staleness`` distribution (one observe per
        tracked row would be O(rows) — the bucketed counts are gauges)."""
        hist: dict[int, int] = {}
        for at in self._encoded_at.values():
            s = self.epoch - at
            hist[s] = hist.get(s, 0) + 1
        if registry is not None:
            for s, n in hist.items():
                registry.gauge("churn.staleness_rows", staleness=s).set(n)
            registry.gauge("churn.staleness_max").set(
                max(hist) if hist else 0)
        return hist

    def __len__(self) -> int:
        return len(self._encoded_at)
