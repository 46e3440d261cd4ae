"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm [arXiv:2402.00838] (port of
``repro/configs/olmo_1b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmo-1b", num_layers=16, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=128, d_ff=8192, vocab_size=50304,
        activation="silu", use_glu=True, qkv_bias=False,
        norm="layernorm_nonparam", rules="lm_attn_dp",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="olmo-1b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=256, vocab_size=257,
        activation="silu", use_glu=True, norm="layernorm_nonparam",
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=16,
        xent_chunk=32,
    )


def adjust(cfg: TransformerConfig, shape_name: str) -> TransformerConfig:
    if shape_name == "train_4k":
        return cfg._replace(train_accum_steps=8, scan_groups=4)
    if shape_name in ("decode_32k", "prefill_32k"):
        return cfg._replace(rules="lm_decode_attn_dp")
    if shape_name == "long_500k":
        return cfg._replace(
            kv_quant=KVQuantConfig(head_dim=128, num_subspaces=16,
                                   num_codewords=256),
            rules="lm_long_ctx_attn_dp",
        )
    return cfg


ARCH = base.ArchSpec(
    arch_id="olmo-1b", family="lm", make_config=make_config,
    make_smoke=make_smoke, shapes=base.LM_SHAPES, adjust=adjust,
    notes="Non-parametric LN (no scale/bias); MHA kv=16.",
)
