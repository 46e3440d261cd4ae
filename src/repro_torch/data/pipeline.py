"""Checkpointable input pipeline with a one-ahead prefetch (port of
``repro/data/pipeline.py``, single device).

A batch is a pure function of (seed, step): ``make_batch(generator)`` is
handed a ``torch.Generator`` on the pipeline's device seeded by
``step_seed(seed, step)``, so the pipeline's state is just ``{"seed",
"step"}`` and a restart resumes exactly.

``prefetch=True`` builds batch k + 1 on a worker thread while the trainer
runs step k. On the card the worker builds it on a side stream of its own
and records an event; the consumer's stream waits on that event, and
every tensor of the batch is ``record_stream``-ed onto the consumer's
stream, so the allocator cannot hand its memory out again while the step
still reads it. The random draws depend on the generator's seed and
offset alone, not on the stream, so the prefetched stream is bit-identical
to the synchronous one. ``state()`` reports the step of the next
unconsumed batch, and ``restore()`` drops an in-flight prefetch (the batch
at the restored step is made again from (seed, step)).
"""
from __future__ import annotations

import concurrent.futures
from typing import Any, Callable

import torch

from repro_torch import device as _device

_MASK = (1 << 63) - 1


def step_seed(seed: int, step: int) -> int:
    """The generator seed of the batch at ``step``: the seed in the high
    bits, the step in the low 32 (a fixed rule, the counterpart of the JAX
    package's ``fold_in(PRNGKey(seed), step)``)."""
    return ((int(seed) << 32) + int(step)) & _MASK


def _tensors(batch) -> list[torch.Tensor]:
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        batch = list(batch.values())
    if isinstance(batch, (list, tuple)):
        return [t for b in batch for t in _tensors(b)]
    return []


class Pipeline:
    """``make_batch(generator) -> batch`` as a stateful, resumable iterator
    (module docstring). ``prefetch_hits`` / ``prefetch_misses`` count
    whether a step's batch was already waiting when the trainer asked for
    it; with a ``registry`` (``repro_torch.obs.Registry``) the same counts
    land on ``pipeline.prefetch_hits`` / ``pipeline.prefetch_misses``."""

    def __init__(self, make_batch: Callable[[torch.Generator], Any],
                 seed: int = 0, prefetch: bool = False,
                 registry: Any | None = None, device=None):
        self._make = make_batch
        self._seed = int(seed)
        self._step = 0
        self._registry = registry
        self.device = _device.resolve(device)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pipeline-prefetch")
            if prefetch else None)
        self._side = (torch.cuda.Stream(self.device)
                      if prefetch and self.device.type == "cuda" else None)
        self._inflight: tuple[int, concurrent.futures.Future] | None = None

    @property
    def prefetch(self) -> bool:
        return self._pool is not None

    def state(self) -> dict:
        """The step of the next unconsumed batch: an in-flight prefetch is
        not consumed, so a restore from this state replays it exactly."""
        return {"seed": self._seed, "step": self._step}

    def restore(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._step = int(state["step"])
        self._inflight = None

    def generator(self, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(step_seed(self._seed, step))
        return g

    def peek_generator(self) -> torch.Generator:
        """The generator the next batch will be made from."""
        return self.generator(self._step)

    def _produce(self, step: int):
        return self._make(self.generator(step))

    def _produce_side(self, step: int):
        """On the worker: the batch made on the side stream, and the event
        that marks it done (None off the card)."""
        if self._side is None:
            return self._produce(step), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            batch = self._produce(step)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return batch, ready

    def _count(self, name: str) -> None:
        if self._registry is not None:
            self._registry.counter(f"pipeline.{name}").inc()

    def __iter__(self):
        return self

    def __next__(self):
        if self._pool is None:
            batch = self._produce(self._step)
            self._step += 1
            return batch
        if self._inflight is not None and self._inflight[0] == self._step:
            batch, ready = self._inflight[1].result()
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in _tensors(batch):
                    t.record_stream(stream)
            self.prefetch_hits += 1
            self._count("prefetch_hits")
        else:
            # a cold start, a restore, or a stale slot: made here, on the
            # consumer's stream (counted; the steady state hits)
            batch = self._produce(self._step)
            self.prefetch_misses += 1
            self._count("prefetch_misses")
        self._step += 1
        self._inflight = (self._step,
                          self._pool.submit(self._produce_side, self._step))
        return batch

    def close(self) -> None:
        """Shut the prefetch worker down (idempotent; a no-op without
        prefetch)."""
        if self._pool is not None:
            self._inflight = None
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
