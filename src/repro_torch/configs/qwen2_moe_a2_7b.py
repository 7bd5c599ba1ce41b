"""qwen2-moe-a2.7b [moe]: 24L, d=2048, 16H (kv=16), expert d_ff=1408,
vocab=151936, 60 routed experts top-4 + shared experts (d_ff 5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  The numbers of
``repro/configs/qwen2_moe_a2_7b.py``."""

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.lm_harness import LM_SHAPES, build_lm_cell
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,
        vocab_size=151936,
        attention="gqa",
        qkv_bias=True,
        moe=True,
        num_experts=60,
        num_experts_padded=64,  # the reference's sharding pad; the router masks 60..63
        top_k=4,
        d_ff_expert=1408,
        d_ff_shared=5632,  # 4 shared experts fused into one 4×1408 SwiGLU
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab_size=256,
        attention="gqa",
        qkv_bias=True,
        moe=True,
        num_experts=8,
        top_k=2,
        d_ff_expert=32,
        d_ff_shared=64,
        dtype=torch.float32,
        attn_block_q=16,
        attn_block_k=16,
    )


ARCH = ArchSpec(
    name="qwen2-moe-a2.7b",
    family="lm",
    full=full,
    smoke=smoke,
    shapes=LM_SHAPES,
    build_cell=build_lm_cell,
    notes="4 shared + 60 routed top-4; shared experts fused into one SwiGLU "
    "of width 4x1408=5632 with a sigmoid shared-expert gate. long_500k skipped.",
)
