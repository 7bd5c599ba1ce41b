"""qwen2-72b [dense]: 80L, d=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
GQA with QKV bias.  [arXiv:2407.10671; hf]  The numbers of
``repro/configs/qwen2_72b.py``."""

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.lm_harness import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        attention="gqa",
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attention="gqa",
        qkv_bias=True,
        dtype=torch.float32,
        attn_block_q=16,
        attn_block_k=16,
    )


ARCH = ArchSpec(
    name="qwen2-72b",
    family="lm",
    full=full,
    smoke=smoke,
    shapes=LM_SHAPES,
    notes="long_500k skipped: full-softmax attention.",
)
