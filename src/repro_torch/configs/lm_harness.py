"""Step functions for the LM-family architectures: the port of
``repro/configs/lm_harness.py``'s prefill and serve steps.

Shapes (assigned): train_4k (train_step), prefill_32k (prefill), decode_32k
(serve_step: 1 new token against a seq_len KV cache).  Training and the
mesh-sharded cells wait for their slices (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from repro_torch.configs.common import ShapeDef
from repro_torch.models import transformer as tf

LM_SHAPES = {
    "train_4k": ShapeDef("train", dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeDef("prefill", dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeDef("decode", dict(seq_len=32768, global_batch=128)),
}


def make_prefill(cfg: tf.TransformerConfig):
    def prefill(params, tokens):
        logits, cache, _ = tf.forward(cfg, params, tokens)
        # a copy, so the [B, S, vocab] logits are freed on return
        return logits[:, -1].clone(), cache

    return prefill


def make_decode(cfg: tf.TransformerConfig):
    def serve_step(params, cache, tokens, pos):
        return tf.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
