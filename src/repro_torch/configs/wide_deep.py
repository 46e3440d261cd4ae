"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat [arXiv:1606.07792; paper] (port of
``repro/configs/wide_deep.py``).

1M rows a field × 40 fields = a 40M-row fused table (5.12 GB in float32)
and a 0.16 GB wide table, whole on one card here (the sharded slice would
split the rows over the model axis)."""
import torch

from repro_torch.configs import base
from repro_torch.models.recsys import WideDeepConfig


def make_config() -> WideDeepConfig:
    return WideDeepConfig(
        name="wide-deep", n_sparse=40, vocab_per_field=1_000_000,
        embed_dim=32, mlp_dims=(1024, 512, 256),
        dtype=torch.float32, param_dtype=torch.float32,
    )


def make_smoke() -> WideDeepConfig:
    return WideDeepConfig(
        name="wide-deep-smoke", n_sparse=6, vocab_per_field=128,
        embed_dim=8, mlp_dims=(32, 16),
        dtype=torch.float32, param_dtype=torch.float32,
    )


ARCH = base.ArchSpec(
    arch_id="wide-deep", family="recsys", make_config=make_config,
    make_smoke=make_smoke, shapes=base.RECSYS_SHAPES,
    notes="Fused 40M-row table; wide = per-id weight table.",
)
