"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval [RecSys'19 (YouTube)] (port of
``repro/configs/two_tower_retrieval.py``).

The paper's architecture: the GCD-rotated PQ index layer sits on the item
tower (Fig. 1); retrieval_cand scores 1M candidates by ADC over PQ codes."""
import torch

from repro_torch.configs import base
from repro_torch.core.index_layer import IndexLayerConfig
from repro_torch.models.recsys import TwoTowerConfig


def make_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="two-tower-retrieval", item_vocab=10_000_000, embed_dim=256,
        tower_dims=(1024, 512, 256), hist_len=50, scoring="cosine",
        hinge_margin=0.1,
        index=IndexLayerConfig(dim=256, num_subspaces=32, num_codewords=256),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="two-tower-smoke", item_vocab=2048, embed_dim=16,
        tower_dims=(32, 16), hist_len=8, scoring="cosine",
        index=IndexLayerConfig(dim=16, num_subspaces=4, num_codewords=16),
        dtype=torch.float32, param_dtype=torch.float32,
    )


ARCH = base.ArchSpec(
    arch_id="two-tower-retrieval", family="recsys", make_config=make_config,
    make_smoke=make_smoke, shapes=base.RECSYS_SHAPES,
    notes="Paper's own setting: index layer on item tower, ADC retrieval.",
)
