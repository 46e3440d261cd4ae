"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper] (port of
``repro/configs/din.py``).

A pure ranker; retrieval_cand scores 1M candidates for one user by bulk
target attention (``recsys.din_score_candidates``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.recsys import DINConfig


def make_config() -> DINConfig:
    return DINConfig(
        name="din", item_vocab=1_000_000, embed_dim=18, hist_len=100,
        attn_dims=(80, 40), mlp_dims=(200, 80),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> DINConfig:
    return DINConfig(
        name="din-smoke", item_vocab=512, embed_dim=18, hist_len=16,
        attn_dims=(20, 10), mlp_dims=(32, 16),
        dtype=torch.float32, param_dtype=torch.float32,
    )


ARCH = base.ArchSpec(
    arch_id="din", family="recsys", make_config=make_config,
    make_smoke=make_smoke, shapes=base.RECSYS_SHAPES,
    notes="Target attention over 100-item history; BCE ranking loss.",
)
