"""Live churn for servable indexes (port of ``repro/churn``).

Staged adds, tombstone deletes and compaction over the search states, made
so that the serving path never changes shape:

  * ``buffer``: fixed-capacity append buffers and the flat-ADC side pass
    (the ``adc_lookup`` kernel) that serves staged rows;
  * ``ops``: the primitives ``with_staging``, ``stage``, ``flush``,
    ``tombstone`` and ``compact``, state in, state out;
  * ``controller``: ``ChurnController`` sequences stage → flush → compact
    between Engine batches, on the Engine's registry;
  * ``compactor``: ``BackgroundCompactor`` builds the next compacted state
    in a worker thread and swaps it in at the refresh point (deletes
    replayed, staging and rotation taken from the current state);
  * ``staleness``: ``StalenessTracker``, the rotation epoch each row was
    encoded at, so a compaction re-encodes only the stalest rows.

Deletes are id flips the scan kernels mask; adds are visible to the next
query through the side pass; compaction repacks at the same shapes in
steady state. The sharded states churn shard by shard, and
``shard_rebalance`` moves rows between shards whose occupancy drifted.
"""
from repro_torch.churn.buffer import (  # noqa: F401
    StagingBuffer,
    empty,
    merge_staged,
    staged_topk,
)
from repro_torch.churn.compactor import BackgroundCompactor  # noqa: F401
from repro_torch.churn.controller import ChurnController  # noqa: F401
from repro_torch.churn.ops import (  # noqa: F401
    compact,
    flush,
    free_slots,
    ingest_index,
    live_rows,
    shard_rebalance,
    shard_rows,
    stage,
    staged_rows,
    staging_capacity,
    tombstone,
    tombstone_index,
    with_staging,
)
from repro_torch.churn.staleness import StalenessTracker  # noqa: F401

__all__ = [
    "StagingBuffer", "empty", "merge_staged", "staged_topk",
    "ChurnController", "BackgroundCompactor", "StalenessTracker",
    "with_staging", "stage", "flush", "tombstone", "compact",
    "shard_rebalance", "tombstone_index", "ingest_index",
    "staged_rows", "free_slots", "live_rows", "staging_capacity",
    "shard_rows",
]
