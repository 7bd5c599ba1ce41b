"""minicpm3-4b [dense]: 62L, d=2560, 40H, d_ff=6400, vocab=73448 — MLA
(multi-head latent attention, compressed KV cache).
[hf:openbmb/MiniCPM3-4B; hf]  The numbers of ``repro/configs/minicpm3_4b.py``."""

import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.lm_harness import LM_SHAPES, build_lm_cell
from repro_torch.models.transformer import TransformerConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm3-4b",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=96,  # nope+rope
        d_ff=6400,
        # true vocab 73448, padded to 73728 (= 16*4608) by the reference for
        # its 16-way model axis; the extra rows are dead
        vocab_size=73728,
        attention="mla",
        q_rank=768,
        kv_rank=256,
        nope_dim=64,
        rope_dim=32,
        v_head_dim=64,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm3-4b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=128,
        vocab_size=256,
        attention="mla",
        q_rank=32,
        kv_rank=16,
        nope_dim=16,
        rope_dim=8,
        v_head_dim=16,
        dtype=torch.float32,
        attn_block_q=16,
        attn_block_k=16,
    )


ARCH = ArchSpec(
    name="minicpm3-4b",
    family="lm",
    full=full,
    smoke=smoke,
    shapes=LM_SHAPES,
    build_cell=build_lm_cell,
    notes="MLA: decode cache stores (c_kv, k_rope) latents, not full K/V. "
    "long_500k skipped: full-softmax attention.",
)
