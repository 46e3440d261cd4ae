"""Background compaction: repack the next state off the serving path (port
of ``repro/churn/compactor.py``).

``ChurnController.compact`` runs ``ops.compact`` between Engine batches; at
full corpus size that host-side repack is the loop's p99.
``BackgroundCompactor`` moves it to a worker thread that builds the next
state while the current one serves, and swaps it in at the Engine's refresh
point (a whole ``engine.state`` assignment on the polling thread, as
``Engine.refresh`` does).

The worker compacts a snapshot, so by the swap the live state may have
moved. The rules:

  * ``tombstone`` since the submit: replayed onto the compacted ids.
  * ``stage`` since the submit: the staged rows live in the staging
    buffer, and the swap takes the buffer from the current state (the
    worker compacts with ``include_staged=False``), so they keep serving.
  * ``refresh`` since the submit: a refresh carries the codes and moves
    R, the coarse centroids, the quantizer and the fused matrices; the swap
    takes all of them from the current state.
  * ``flush``/``compact`` since the submit: the CSR moved under the worker,
    and the result is discarded (``churn.bg_discarded``). The check: the
    offsets and the id tensor's shape unchanged, and the current ids equal
    the snapshot's wherever the current row is live, so the only change is
    tombstones. (The JAX package checks that the current live ids are a
    subset of the snapshot's as sets; at unchanged offsets the positional
    form costs one device comparison instead of two Python sets of every
    live id, and it discards no pass that the set form keeps unless rows
    moved within the CSR, which only a flush or a compaction does.) The
    controller defers flushes while a pass is in flight, so discards stay
    rare.

Codes are carried, so a pass that raced nothing is bit-equal to a
foreground ``ops.compact`` of the same snapshot.

With a ``StalenessTracker`` and a ``reencode_fn(ids) -> raw vectors`` (an
array, or a tensor on any device), each
pass re-encodes the stalest rows (``ops.compact(reencode=...)``) inside
maintenance the index does anyway.

Threads and streams. The worker does pure compute: it writes no registry
and no engine state, and returns ``(state, elapsed_s)`` through a Future.
Registry writes and the swap happen in ``poll()`` on the caller's thread,
under one lock (no torn stats, no double swap). The worker's device work
(the host-to-device copies of the repacked CSR, the re-encode's
``pq_assign``) runs on the thread's current stream, which is the device's
default stream, the one the Engine serves on: its copies queue behind the
batches already launched, and the new tensors are ready, in stream order,
for every batch launched after the swap. So the swap needs no event and no
``record_stream``. ``churn.compact_hidden_ms`` is the worker's wall time,
as the JAX package defines it: what the pass could hide at most. What it
does hide is less: the submit (the tracker's ``stalest``) and the swap's
poll (the tracker's ``histogram``) run on the caller's thread, and the
worker's host work (the gather, the sort and the scatter of ``ivf.pack``)
contends with the serving loop for the GIL; ``chip_smoke.py``'s churn
phase measures it (``_hidden_ms``). Every state the worker reads is a
snapshot no primitive writes into (``churn.ops``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.churn import ops
from repro_torch.obs.registry import synchronize


def _index_of(state):
    """The state's IVFPQIndex (an ADC state's, or a bare index)."""
    return state.index if hasattr(state, "index") else state


class BackgroundCompactor:
    """Double-buffered ``ops.compact`` with a reconcile at the swap.

    ``engine`` is anything with a ``.state`` (``search.Engine`` or a bare
    holder). ``tracker``/``reencode_fn``/``reencode_rows`` wire the
    staleness pass; ``worker_delay_s`` delays the worker (stress tests).
    ``submit``/``poll`` may be called from one thread at a time (they
    lock); the worker never writes shared state.
    """

    def __init__(self, engine, *, tracker=None, reencode_fn=None,
                 reencode_rows: int = 256, include_staged: bool = False,
                 worker_delay_s: float = 0.0, registry=None):
        self.engine = engine
        self.tracker = tracker
        self.reencode_fn = reencode_fn
        self.reencode_rows = int(reencode_rows)
        self.include_staged = bool(include_staged)
        self.worker_delay_s = float(worker_delay_s)
        self.obs = (registry if registry is not None
                    else getattr(engine, "obs", None)
                    or obs.default_registry())
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="churn-compact")
        self._future: concurrent.futures.Future | None = None
        self._snap_index = None
        self._snap_epoch = 0
        self._reencode_ids: np.ndarray | None = None

    # -- worker body: pure compute, no registry or engine writes -----------
    def _work(self, snapshot, reencode):
        if self.worker_delay_s > 0:
            time.sleep(self.worker_delay_s)
        t0 = time.perf_counter()
        new = ops.compact(snapshot, include_staged=self.include_staged,
                          reencode=reencode)
        synchronize(_index_of(new).ids)
        return new, time.perf_counter() - t0

    @property
    def in_flight(self) -> bool:
        with self._lock:
            return self._future is not None

    def submit(self) -> bool:
        """Snapshot the current state and start compacting it in the
        background. Returns False (a no-op) when a pass is in flight."""
        with self._lock:
            if self._future is not None:
                return False
            snapshot = self.engine.state
            self._snap_index = _index_of(snapshot)
            reencode = None
            self._reencode_ids = None
            if (self.tracker is not None and self.reencode_fn is not None
                    and self.reencode_rows > 0):
                rid = self.tracker.stalest(self.reencode_rows)
                if rid.size:
                    vecs = self.reencode_fn(rid)
                    if not isinstance(vecs, torch.Tensor):
                        vecs = np.asarray(vecs)
                    reencode = (rid, vecs)
                    self._reencode_ids = rid
            self._snap_epoch = (self.tracker.epoch
                                if self.tracker is not None else 0)
            self._future = self._pool.submit(self._work, snapshot, reencode)
            return True

    def _dead_since_submit(self, current) -> torch.Tensor | None:
        """The ids tombstoned since the submit, or None when the CSR moved
        (see the module docstring's check)."""
        snap, cur = self._snap_index, _index_of(current)
        if (cur.ids.shape != snap.ids.shape
                or not torch.equal(cur.list_offsets, snap.list_offsets)):
            return None
        cur_live = cur.ids >= 0
        if not bool(torch.all(~cur_live | (cur.ids == snap.ids))):
            return None
        return snap.ids[(snap.ids >= 0) & ~cur_live]

    def poll(self) -> bool:
        """Take a finished pass: validate, reconcile, swap. True when a swap
        happened. Never waits for an unfinished worker. Every metric write
        happens here, on the caller's thread."""
        with self._lock:
            fut = self._future
            if fut is None or not fut.done():
                return False
            self._future = None          # taken once: no double swap
            compacted, elapsed = fut.result()
            current = self.engine.state
            dead = self._dead_since_submit(current)
            self._snap_index = None
            if dead is None:
                self.obs.counter("churn.bg_discarded").inc()
                return False
            self.engine.state = self._swap(current, compacted, dead)

            if self.tracker is not None:
                if self._reencode_ids is not None:
                    self.tracker.record(self._reencode_ids,
                                        epoch=self._snap_epoch)
                    self.obs.counter("churn.reencoded").inc(
                        int(self._reencode_ids.size))
                if dead.numel():
                    self.tracker.forget(dead.cpu().numpy())
                self.tracker.histogram(self.obs)
            self.obs.counter("churn.bg_compactions").inc()
            self.obs.distribution("churn.bg_compact_ms").observe(
                elapsed * 1e3)
            # the worker's wall time: the most the pass could hide
            self.obs.distribution("churn.compact_hidden_ms").observe(
                elapsed * 1e3)
            return True

    @staticmethod
    def _swap(current, compacted, dead: torch.Tensor):
        """The state after the swap: the CSR layout of the compacted
        snapshot (deletes replayed); everything a refresh moves and the
        staging buffer from the current state."""
        comp = _index_of(compacted)
        ids = comp.ids
        if dead.numel():
            ids = ops._tombstone_ids(ids, dead)
        new_idx = dataclasses.replace(
            _index_of(current), codes=comp.codes, ids=ids,
            list_offsets=comp.list_offsets)
        if not hasattr(current, "index"):    # a bare IVFPQIndex
            return new_idx
        return dataclasses.replace(current, index=new_idx,
                                   max_blocks=compacted.max_blocks)

    def join(self, timeout: float | None = None) -> None:
        """Wait until the in-flight worker (if any) finishes; it still
        needs a ``poll()`` to swap."""
        with self._lock:
            fut = self._future
        if fut is not None:
            concurrent.futures.wait([fut], timeout=timeout)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
