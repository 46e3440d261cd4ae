"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared ReLU, no GLU [arXiv:2402.16819] (port of
``repro/configs/nemotron_4_340b.py``). The full config does not fit one
card; the port runs it at smoke width, the dense GQA config (rep 4)."""
import torch

from repro_torch.configs import base
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="nemotron-4-340b", num_layers=96, d_model=18432, num_heads=96,
        num_kv_heads=8, head_dim=192, d_ff=73728, vocab_size=256000,
        activation="relu2", use_glu=False, qkv_bias=False, norm="rmsnorm",
        rules="lm_base", dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        q_chunk=256,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="nemotron-4-340b-smoke", num_layers=2, d_model=96, num_heads=8,
        num_kv_heads=2, head_dim=12, d_ff=384, vocab_size=500,
        activation="relu2", use_glu=False, norm="rmsnorm",
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=16,
        xent_chunk=32,
    )


def adjust(cfg: TransformerConfig, shape_name: str) -> TransformerConfig:
    if shape_name == "train_4k":
        return cfg._replace(train_accum_steps=16, scan_groups=8,
                            rules="lm_base_bigtrain")
    if shape_name in ("decode_32k", "prefill_32k"):
        return cfg._replace(rules="lm_decode")
    if shape_name == "long_500k":
        return cfg._replace(
            kv_quant=KVQuantConfig(head_dim=192, num_subspaces=24,
                                   num_codewords=256),
            rules="lm_long_ctx",
        )
    return cfg


ARCH = base.ArchSpec(
    arch_id="nemotron-4-340b", family="lm", make_config=make_config,
    make_smoke=make_smoke, shapes=base.LM_SHAPES, adjust=adjust,
    notes="Squared-ReLU non-GLU FFN; GQA kv=8.",
)
