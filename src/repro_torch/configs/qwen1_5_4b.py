"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936, QKV bias (port of ``repro/configs/qwen1_5_4b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-4b", num_layers=40, d_model=2560, num_heads=20,
        num_kv_heads=20, head_dim=128, d_ff=6912, vocab_size=151936,
        activation="silu", use_glu=True, qkv_bias=True, norm="rmsnorm",
        rope_theta=1_000_000.0, rules="lm_attn_dp",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-4b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=269,
        activation="silu", use_glu=True, qkv_bias=True, norm="rmsnorm",
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
    arch_id="qwen1.5-4b", family="lm", make_config=make_config,
    make_smoke=make_smoke, shapes=base.LM_SHAPES, adjust=adjust,
    notes="QKV bias; MHA (kv=20).",
)
