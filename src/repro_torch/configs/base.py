"""Architecture registry scaffolding (port of ``repro/configs/base.py``
for the families ported so far: the LM grid and the recsys shapes; the GNN
grid waits for its slice).

Every ported architecture ships one module exposing an ``ArchSpec``:
  * ``make_config()``      — the full published config
  * ``make_smoke()``       — a reduced same-family config for CPU tests
  * ``shapes``             — the architecture's own input-shape set
  * ``config_for_shape()`` — per-shape adjustments (the PQ KV cache
                             switches on for ``long_500k``)
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Shape(NamedTuple):
    kind: str            # train | prefill | decode | recsys_train
    #                      | recsys_serve | recsys_retrieval
    params: dict[str, Any]


class ArchSpec(NamedTuple):
    arch_id: str
    family: str          # lm | recsys
    make_config: Callable[[], Any]
    make_smoke: Callable[[], Any]
    shapes: dict[str, Shape]
    adjust: Callable[[Any, str], Any] | None = None  # (cfg, shape) -> cfg
    notes: str = ""

    def config_for_shape(self, shape_name: str):
        cfg = self.make_config()
        if self.adjust is not None:
            cfg = self.adjust(cfg, shape_name)
        return cfg


# The LM shape grid (the same four shapes for every LM architecture). A
# dense cache at 524,288 positions does not fit; long_500k runs the paper's
# technique instead: the PQ-compressed KV cache, ADC attention.
LM_SHAPES = {
    "train_4k": Shape("train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": Shape("prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": Shape("decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": Shape("decode", {"seq_len": 524288, "global_batch": 1,
                                   "pq_cache": True}),
}

RECSYS_SHAPES = {
    "train_batch": Shape("recsys_train", {"batch": 65536}),
    "serve_p99": Shape("recsys_serve", {"batch": 512}),
    "serve_bulk": Shape("recsys_serve", {"batch": 262144}),
    "retrieval_cand": Shape("recsys_retrieval", {"batch": 1,
                                                 "n_candidates": 1_000_000}),
}
