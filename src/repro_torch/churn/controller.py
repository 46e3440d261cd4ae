"""ChurnController: stage → flush → compact between Engine batches (port of
``repro/churn/controller.py``).

The policy over ``churn.ops``: it decides when the primitives run, so a
serving loop only interleaves ``engine.search`` with ``controller.step``.
Its one structural change happens at construction: it installs the staging
buffer (``ops.with_staging``) before the first search, so every executable
the Engine makes serves staged rows, and the add/delete/flush/compact cycle
after that keeps every shape. ``engine.state`` is swapped whole after each
mutation (the Engine reads it per batch).

Thresholds:

  flush_at     staging occupancy (a fraction) that triggers a flush after
               a ``step``'s mutations (keeps the side pass small);
  compact_at   tombstoned rows as a fraction of the CSR's capacity that
               trigger a compaction (reclaims dead blocks before they
               dominate the scan); compaction also takes the staged rows no
               flush could place;
  imbalance_threshold
               sharded states: the largest shard's live rows (staged ones
               counted) over the mean that triggers ``shard_rebalance``.

The metrics go on the Engine's own always-on registry, so
``Engine.stats()["churn"]`` reports them beside the serving counters:
counters ``churn.staged/flushed/tombstoned/flushes/compactions/rebalances/
grows``, gauges ``churn.staged_rows/tombstoned_rows``, the
``churn.flush_ms`` distribution and the ``churn.flush``/``churn.compact``
spans.

The tombstone tally is the controller's own: a row flipped to −1 looks like
a build-time padding hole, so the gauge counts the deletes since the last
compaction, and a compaction resets it.

With a ``BackgroundCompactor`` (``compactor=``), ``compact()`` submits a
pass without waiting and each ``step`` polls for a finished one to swap in.
Flushes are deferred while a pass is in flight (a flush moves the CSR and
would make the worker's result stale); the one blocking fallback is an
``add`` into a full buffer, which joins the worker before it flushes.

Sharded states (``search.sharded``) run the same cycle shard by shard,
plus ``maybe_rebalance`` after every step.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.churn import ops


class ChurnController:
    """Drive live churn on a ``search.Engine`` (see module docstring)."""

    def __init__(self, engine, *, staging_rows: int = 1024,
                 flush_at: float = 0.5, compact_at: float = 0.25,
                 imbalance_threshold: float = 1.25, compactor=None):
        self.engine = engine
        self.flush_at = float(flush_at)
        self.compact_at = float(compact_at)
        self.imbalance_threshold = float(imbalance_threshold)
        self.obs = getattr(engine, "obs", None) or obs.default_registry()
        self.compactor = compactor
        self._tombstoned_at_submit = 0
        self._tombstoned = 0
        # the one structural change: the buffer goes in before the first
        # search
        if getattr(engine.state, "staging", None) is None:
            engine.state = ops.with_staging(engine.state, staging_rows)
        self._gauges()

    # -- metric plumbing ---------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        self.obs.counter(f"churn.{name}").inc(n)

    def _gauges(self) -> None:
        self.obs.gauge("churn.staged_rows").set(ops.staged_rows(self.state))
        self.obs.gauge("churn.tombstoned_rows").set(self._tombstoned)

    @property
    def state(self):
        return self.engine.state

    # -- mutations ---------------------------------------------------------
    def add(self, X_new, new_ids) -> None:
        """Stage new rows; the very next query serves them. Flushes first
        (and compacts, if a flush cannot free enough slots) when the buffer
        cannot hold the batch."""
        n = len(new_ids)
        if ops.free_slots(self.state) < n:
            if self.compactor is not None and self.compactor.in_flight:
                # the one blocking fallback: a full buffer needs a flush,
                # and a flush would make the in-flight snapshot stale
                self.compactor.join()
                self.poll_background()
            self.flush()
        if ops.free_slots(self.state) < n:
            self._compact_sync()
        self.engine.state = ops.stage(self.state, X_new, new_ids)
        self._count("staged", n)
        self._gauges()

    def remove(self, remove_ids) -> None:
        """Tombstone rows by id: O(1), visible to the next query."""
        before = ops.live_rows(self.state)
        self.engine.state = ops.tombstone(self.state, remove_ids)
        dead = before - ops.live_rows(self.state)
        self._tombstoned += dead
        self._count("tombstoned", dead)
        self._gauges()

    # -- maintenance -------------------------------------------------------
    def flush(self) -> int:
        """Fold staged rows into CSR holes (same shapes). Deferred
        (returns 0) while a background compaction is in flight."""
        if self.compactor is not None and self.compactor.in_flight:
            self._count("flushes_deferred")
            return 0
        with self.obs.span("churn.flush") as sp:
            new_state, moved = ops.flush(self.state)
            sp.sync(_csr_ids(new_state))
        self.engine.state = new_state
        self.obs.distribution("churn.flush_ms").observe(sp.elapsed_ms)
        self._count("flushes")
        self._count("flushed", moved)
        self._gauges()
        return moved

    def compact(self) -> None:
        """Repack the live (and staged) rows, reclaiming tombstoned blocks:
        a submit that does not wait with a ``BackgroundCompactor`` (the
        swap lands on a later ``step``/``poll_background``), else on this
        thread. A change of capacity or probe window is counted in
        ``churn.grows``."""
        if self.compactor is not None:
            if self.compactor.submit():
                self._tombstoned_at_submit = self._tombstoned
                self._count("bg_submitted")
            return
        self._compact_sync()

    def _compact_sync(self) -> None:
        st = self.state
        cap_before, mb_before = _capacity(st), st.max_blocks
        with self.obs.span("churn.compact") as sp:
            new_state = ops.compact(st)
            sp.sync(_csr_ids(new_state))
        self.engine.state = new_state
        if (_capacity(new_state) != cap_before
                or new_state.max_blocks != mb_before):
            self._count("grows")
        self._count("compactions")
        self._tombstoned = 0
        self._gauges()

    def poll_background(self) -> bool:
        """Swap in a finished background compaction, if one is ready. The
        compactor replayed the deletes made since its submit, so only they
        stay tombstoned after the swap."""
        if self.compactor is None or not self.compactor.poll():
            return False
        self._tombstoned = max(
            0, self._tombstoned - self._tombstoned_at_submit)
        self._count("compactions")
        self._gauges()
        return True

    def maybe_rebalance(self) -> bool:
        """Sharded states only: ``shard_rebalance`` when the largest
        shard's live rows (staged ones counted) exceed the mean by
        ``imbalance_threshold``. Returns whether a rebalance ran."""
        st = self.state
        if not hasattr(st, "shards"):
            return False
        rows = ops.shard_rows(st)
        imbalance = max(rows) / max(sum(rows) / len(rows), 1.0)
        if imbalance <= self.imbalance_threshold:
            return False
        with self.obs.span("churn.rebalance") as sp:
            self.engine.state = ops.shard_rebalance(st)
            sp.sync(_csr_ids(self.engine.state))
        self._count("rebalances")
        self._tombstoned = 0    # the repack reclaims tombstones too
        self._gauges()
        return True

    # -- the per-batch policy ----------------------------------------------
    def step(self, *, add=None, add_ids=None, remove_ids=None) -> None:
        """One churn tick between query batches: this tick's deletes and
        adds, then whatever maintenance the thresholds call for."""
        self.poll_background()
        if remove_ids is not None and len(remove_ids):
            self.remove(remove_ids)
        if add is not None and len(add_ids):
            self.add(add, add_ids)
        st = self.state
        cap = ops.staging_capacity(st)
        if cap and ops.staged_rows(st) >= self.flush_at * cap:
            self.flush()
        if self._tombstoned >= self.compact_at * max(_total_capacity(st), 1):
            self.compact()
        self.maybe_rebalance()


def _csr_ids(state):
    """The CSR id tensor(s) a span waits for: one, or one a shard."""
    return state.ids if hasattr(state, "shards") else state.index.ids


def _capacity(state) -> int:
    """CSR rows (a shard's, on a sharded state)."""
    return state.capacity if hasattr(state, "shards") else \
        state.index.capacity


def _total_capacity(state) -> int:
    """CSR rows over every shard."""
    if hasattr(state, "shards"):
        return state.capacity * state.num_shards
    return state.index.capacity
