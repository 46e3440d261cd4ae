"""Shape scaffolding (port of the ``RECSYS_SHAPES`` part of
``repro/configs/base.py``; the LM and GNN grids and ``ArchSpec`` wait for
the slices that port those families)."""
from __future__ import annotations

from typing import Any, NamedTuple


class Shape(NamedTuple):
    kind: str            # recsys_train | recsys_serve | recsys_retrieval
    params: dict[str, Any]


RECSYS_SHAPES = {
    "train_batch": Shape("recsys_train", {"batch": 65536}),
    "serve_p99": Shape("recsys_serve", {"batch": 512}),
    "serve_bulk": Shape("recsys_serve", {"batch": 262144}),
    "retrieval_cand": Shape("recsys_retrieval", {"batch": 1,
                                                 "n_candidates": 1_000_000}),
}
