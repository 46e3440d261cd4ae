"""The overlapped training runtime (port of ``repro/pipeline``).

Rotation learning during training with a live index, with the slow host
pieces off the step's critical path:

  * ``data.pipeline.Pipeline(prefetch=True)``: batch k + 1 is made on a
    worker thread (on a side stream on the card) while step k runs; the
    stream is bit-identical to the synchronous one, and ``state()`` /
    ``restore()`` carry the cursor;
  * ``LiveIndexLoop``: takes each step's ``RotationDelta``
    (``make_train_step(emit_deltas=True)``) and refreshes a live Engine
    every N steps, keeping its executables and state shapes, and tracks
    each row's staleness so only drifted rows are re-encoded;
  * ``churn.BackgroundCompactor``: repacks the next index state on a
    worker thread and swaps it in at the refresh point; the staleness
    re-encode rides inside each pass.

``repro_torch.bench.train_e2e`` measures the assembled loop.
"""
from repro_torch.churn.compactor import BackgroundCompactor
from repro_torch.churn.staleness import StalenessTracker
from repro_torch.data.pipeline import Pipeline
from repro_torch.pipeline.loop import LiveIndexLoop

__all__ = ["Pipeline", "LiveIndexLoop", "BackgroundCompactor",
           "StalenessTracker"]
