"""Tiny sizes of the benchmark's cells, for the CPU tests: the cells' own
files with the widths and counts cut, run on the CPU (the port's plain
versions)."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 977
SECONDS = 0.3


def shrink(name: str) -> tuple[dict, dict]:
    """(workload, config) of a cell at a size the CPU runs in a second."""
    wl = copy.deepcopy(harness.workload(name))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    if wl["driver"] == "engine_closed":
        cfg.update(item_vocab=4000, embed_dim=32,
                   index=dict(dim=32, num_subspaces=4, num_codewords=16,
                              distortion_weight=1.0),
                   ivf=dict(num_lists=16, block_size=32, train_size=2000,
                            kmeans_iters=3))
        wl["traffic"].update(batch=64, nprobe=4, queries=2048,
                             warmup_batches=4, check_queries=64)
    else:
        cfg.update(item_vocab=3000, embed_dim=32, tower_dims=[32, 32],
                   hist_len=8, train_batch=128, click_dim=8,
                   index=dict(dim=32, num_subspaces=4, num_codewords=16,
                              distortion_weight=1.0))
    return wl, cfg


def run(name: str, trace: bool = False, seed: int = SEED,
        bench: dict | None = None) -> dict:
    wl, cfg = shrink(name)
    return harness.run_cell(name, wl, cfg, bench or harness.benchmark(),
                            seed, SECONDS, trace, CPU, time.perf_counter())


def cell(name: str, seed: int = SEED) -> harness.Cell:
    wl, cfg = shrink(name)
    return harness.Cell(name, wl, cfg, seed, SECONDS, False, CPU, 0.0)


CELLS = tuple(w["name"] for w in harness.benchmark()["workloads"])
