"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified] (port of
``repro/configs/mind.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.models.recsys import MINDConfig


def make_config() -> MINDConfig:
    return MINDConfig(
        name="mind", item_vocab=2_000_000, embed_dim=64, n_interests=4,
        capsule_iters=3, hist_len=50,
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> MINDConfig:
    return MINDConfig(
        name="mind-smoke", item_vocab=512, embed_dim=16, n_interests=2,
        capsule_iters=2, hist_len=8,
        dtype=torch.float32, param_dtype=torch.float32,
    )


ARCH = base.ArchSpec(
    arch_id="mind", family="recsys", make_config=make_config,
    make_smoke=make_smoke, shapes=base.RECSYS_SHAPES,
    notes="Capsule B2I routing → 4 interests; retrieval = max over interests.",
)
