"""Architecture registry scaffolding (port of ``repro/configs/base.py``:
the LM grid, the GNN shapes and the recsys shapes).

Every ported architecture ships one module exposing an ``ArchSpec``:
  * ``make_config()``      — the full published config
  * ``make_smoke()``       — a reduced same-family config for CPU tests
  * ``shapes``             — the architecture's own input-shape set
  * ``config_for_shape()`` — per-shape adjustments (the PQ KV cache
                             switches on for ``long_500k``; GraphSAGE takes
                             each graph's feature width)
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Shape(NamedTuple):
    kind: str            # train | prefill | decode | gnn_full | gnn_minibatch
    #                      | gnn_graph_batch | recsys_train | recsys_serve
    #                      | recsys_retrieval
    params: dict[str, Any]


class ArchSpec(NamedTuple):
    arch_id: str
    family: str          # lm | gnn | recsys
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

GNN_SHAPES = {
    "full_graph_sm": Shape("gnn_full", {"n_nodes": 2708, "n_edges": 10556,
                                        "d_feat": 1433}),
    "minibatch_lg": Shape("gnn_minibatch", {"n_nodes": 232965,
                                            "n_edges": 114615892,
                                            "batch_nodes": 1024,
                                            "fanout": (15, 10),
                                            "d_feat": 602}),
    "ogb_products": Shape("gnn_full", {"n_nodes": 2449029,
                                       "n_edges": 61859140, "d_feat": 100}),
    "molecule": Shape("gnn_graph_batch", {"n_nodes": 30, "n_edges": 64,
                                          "batch": 128, "d_feat": 64}),
}

RECSYS_SHAPES = {
    "train_batch": Shape("recsys_train", {"batch": 65536}),
    "serve_p99": Shape("recsys_serve", {"batch": 512}),
    "serve_bulk": Shape("recsys_serve", {"batch": 262144}),
    "retrieval_cand": Shape("recsys_retrieval", {"batch": 1,
                                                 "n_candidates": 1_000_000}),
}
