"""arctic-480b [moe]: 35L, d=7168, 56H (GQA kv=8), dense d_ff=4864 residual
∥ MoE 128 experts top-2 (expert d_ff=4864), vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]  The numbers of
``repro/configs/arctic_480b.py``."""

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.lm_harness import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,  # dense residual branch
        vocab_size=32000,
        attention="gqa",
        moe=True,
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,  # dense-MoE hybrid: dense FFN ∥ MoE every layer
        capacity_factor=1.25,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attention="gqa",
        moe=True,
        num_experts=8,
        top_k=2,
        d_ff_expert=48,
        dense_residual=True,
        dtype=torch.float32,
        attn_block_q=16,
        attn_block_k=16,
    )


ARCH = ArchSpec(
    name="arctic-480b",
    family="lm",
    full=full,
    smoke=smoke,
    shapes=LM_SHAPES,
    notes="dense-MoE hybrid residual; the reference's EP over the model axis is not "
    "ported (one card holds every expert). long_500k skipped.",
)
