"""What the port's benchmark scripts share: JSON lines, a device
synchronisation, deterministic algorithms for a block, and the wall-clock
timer of ``benchmarks/common.py`` with a CUDA-event time beside it."""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time

import torch


def emit(bench: str, name: str, **fields) -> None:
    print(json.dumps({"bench": bench, "name": name, **fields}), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block, the caller's setting
    restored after. PyTorch accepts the mode for cuBLAS only with a named
    workspace configuration; ``:4096:8`` is set for the block where the
    caller named none (the port runs on one stream, where cuBLAS gives the
    same bits run to run). On the card the k-means sums and the embedding
    tables' gradient (``index_add_``) otherwise add in no fixed order."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def time_call(fn, dev: torch.device, warmup: int = 2, iters: int = 5):
    """(wall µs, device µs, last result) of ``fn()``: the median wall time
    of ``iters`` calls after ``warmup`` calls, each call with the device
    synchronised before and after it, as ``benchmarks/common.py`` blocks
    on JAX's async dispatch; beside it the median time between a CUDA-event
    pair around each call (None on the CPU). The event pair spans every
    gap in which the card waits for the host inside the call, so for a
    call that works on the host (GCD-G's matching) it is close to the wall
    time, not the card's busy time."""
    out = None
    for _ in range(warmup):
        out = fn()
    sync(dev)
    walls, events = [], []
    for _ in range(iters):
        sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            events.append((start, end))
        else:
            out = fn()
        sync(dev)
        walls.append(time.perf_counter() - t0)
    wall_us = statistics.median(walls) * 1e6
    dev_us = (statistics.median(s.elapsed_time(e) for s, e in events) * 1e3
              if events else None)
    return wall_us, dev_us, out
