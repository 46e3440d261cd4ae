"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1; unverified] (port
of ``repro/configs/grok_1_314b.py``)."""
import torch

from repro_torch.configs import base
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="grok-1-314b", num_layers=64, d_model=6144, num_heads=48,
        num_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
        activation="gelu", use_glu=True, qkv_bias=False, norm="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=2), rules="lm_base",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="grok-1-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, head_dim=8, d_ff=128, vocab_size=300,
        activation="gelu", use_glu=True, norm="rmsnorm",
        moe=MoEConfig(num_experts=4, top_k=2),
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=16,
        xent_chunk=32,
    )


def adjust(cfg: TransformerConfig, shape_name: str) -> TransformerConfig:
    if shape_name == "train_4k":
        return cfg._replace(train_accum_steps=16, scan_groups=8,
                            rules="lm_base_bigtrain")
    if shape_name == "prefill_32k":
        return cfg._replace(rules="lm_decode", moe_chunk=131072)
    if shape_name == "decode_32k":
        return cfg._replace(rules="lm_decode")
    if shape_name == "long_500k":
        return cfg._replace(
            kv_quant=KVQuantConfig(head_dim=128, num_subspaces=16,
                                   num_codewords=256),
            rules="lm_long_ctx",
        )
    return cfg


ARCH = base.ArchSpec(
    arch_id="grok-1-314b", family="lm", make_config=make_config,
    make_smoke=make_smoke, shapes=base.LM_SHAPES, adjust=adjust,
    notes="8-expert top-2 MoE (GeGLU experts); expert+head TP on model axis.",
)
