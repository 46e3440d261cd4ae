"""The IVF rule tables of ``repro/sharding/rules.py:103-122``, as plain
tuples: the mesh axes each logical axis of an index shards over (None =
replicated).

``IVF_SHARDED_RULES["ivf_rows"]`` is what ``search.sharded.resolve_axes``
reads: the corpus rows shard over the full product of the ("pod", "data")
axes a mesh has, so a (2, 4) pod × data mesh gives 8 shards, not 4 shards
replicated twice. The LM, GNN and recsys tables wait for the multi-process
backend (ROADMAP.md queue 1, item 11b).
"""
from __future__ import annotations

IVF_RULES: dict = {
    "act_batch": ("pod", "data"),
    "ivf_cand": "model",
    "ivf_cap": None,
    "ivf_lists": None,
    "ivf_rows": None,          # shard axis of a stacked per-shard index
}

IVF_SHARDED_RULES: dict = dict(IVF_RULES)
IVF_SHARDED_RULES.update({
    "ivf_cap": ("pod", "data"),
    "ivf_rows": ("pod", "data"),
})
