"""llama3.2-1b [dense]: 16L, d=2048, 32H (GQA kv=8), d_ff=8192, vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]  The numbers of
``repro/configs/llama3_2_1b.py``."""

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.lm_harness import LM_SHAPES, build_lm_cell
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="llama3.2-1b",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        attention="gqa",
        rope_theta=5e5,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="llama3.2-1b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attention="gqa",
        dtype=torch.float32,
        attn_block_q=16,
        attn_block_k=16,
    )


ARCH = ArchSpec(
    name="llama3.2-1b",
    family="lm",
    full=full,
    smoke=smoke,
    shapes=LM_SHAPES,
    build_cell=build_lm_cell,
    notes="long_500k skipped: full-softmax attention.",
)
