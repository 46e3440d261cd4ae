"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128 experts top-1 [hf:meta-llama/Llama-4-*; unverified]
(port of ``repro/configs/llama4_maverick_400b.py``).

Maverick interleaves dense and MoE layers (moe_every=2): all-MoE at 128
experts would be ~770B, not 400B. The modality frontend ("early fusion")
is out of scope: the backbone consumes token embeddings.
"""
import torch

from repro_torch.configs import base
from repro_torch.core.kv_quant import KVQuantConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-400b-a17b", num_layers=48, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=202048, activation="silu", use_glu=True, qkv_bias=False,
        norm="rmsnorm", moe=MoEConfig(num_experts=128, top_k=1),
        moe_every=2, rules="lm_attn_dp",
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    )


def make_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-smoke", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=301,
        activation="silu", use_glu=True, norm="rmsnorm",
        moe=MoEConfig(num_experts=8, top_k=1), moe_every=2,
        dtype=torch.float32, param_dtype=torch.float32, q_chunk=16,
        xent_chunk=32,
    )


def adjust(cfg: TransformerConfig, shape_name: str) -> TransformerConfig:
    if shape_name == "train_4k":
        return cfg._replace(train_accum_steps=16, scan_groups=6,
                            rules="lm_attn_dp_bigtrain")
    if shape_name == "prefill_32k":
        return cfg._replace(rules="lm_decode_attn_dp", moe_chunk=131072)
    if shape_name == "decode_32k":
        return cfg._replace(rules="lm_decode_attn_dp")
    if shape_name == "long_500k":
        return cfg._replace(
            kv_quant=KVQuantConfig(head_dim=128, num_subspaces=16,
                                   num_codewords=256),
            rules="lm_long_ctx_attn_dp",
        )
    return cfg


ARCH = base.ArchSpec(
    arch_id="llama4-maverick-400b-a17b", family="lm",
    make_config=make_config, make_smoke=make_smoke, shapes=base.LM_SHAPES,
    adjust=adjust,
    notes="Interleaved dense/MoE (every 2nd layer), 128e top-1, EP over "
          "model.",
)
