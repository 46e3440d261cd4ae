"""The paper's own architecture (§3.2), port of
``repro/configs/paper_twotower.py``: a two-tower retrieval model with
embedding size 512, cosine scoring, hinge margin 0.1 and a PQ index layer
(64 subspaces × 256 codewords) with a GCD-learned rotation on the item
tower, over the paper's 1,541,673 unique items."""
from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.core.index_layer import IndexLayerConfig
from repro_torch.models.recsys import TwoTowerConfig


def make_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="paper-twotower", item_vocab=1_541_673,
        embed_dim=512, tower_dims=(512, 512), hist_len=16, scoring="cosine",
        hinge_margin=0.1,
        index=IndexLayerConfig(dim=512, num_subspaces=64, num_codewords=256),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="paper-twotower-smoke", item_vocab=4096, embed_dim=64,
        tower_dims=(64, 64), hist_len=8, scoring="cosine", hinge_margin=0.1,
        index=IndexLayerConfig(dim=64, num_subspaces=8, num_codewords=32),
        dtype=torch.float32, param_dtype=torch.float32,
    )


ARCH = base.ArchSpec(
    arch_id="paper-twotower", family="recsys", make_config=make_config,
    make_smoke=make_smoke, shapes=base.RECSYS_SHAPES,
    notes="Paper §3.2 faithful config (512-dim, hinge 0.1, OPQ warm start).",
)
