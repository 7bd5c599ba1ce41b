"""Step functions for the LM-family architectures: the port of
``repro/configs/lm_harness.py``'s train, prefill and serve steps.

Shapes (assigned): train_4k (train_step), prefill_32k (prefill), decode_32k
(serve_step: 1 new token against a seq_len KV cache).  The reference's
``build_lm_cell`` lowers these on a mesh for its dry-run; the port runs the
steps on one device, and a decode step under ``models.common.
activation_mesh`` of a mesh with a ``model`` axis splits its cache over
that axis (the ``dlse`` attentions).  Splitting the products over cards
(the reference's tensor and expert parallelism) is not ported (ROADMAP
Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import ShapeDef, value_and_grad
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import tree_map

LM_SHAPES = {
    "train_4k": ShapeDef("train", dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeDef("prefill", dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeDef("decode", dict(seq_len=32768, global_batch=128)),
}


def make_train_step(cfg: tf.TransformerConfig, grad_accum: int = 1):
    """``train_step(params, opt_state, tokens, labels)`` → (new params, new
    optimizer state, ``{"loss", "gnorm"}``): :func:`transformer.loss_fn`'s
    value and gradient by autograd, then AdamW at lr 3e-4.

    ``grad_accum > 1`` splits the batch into that many microbatches of
    consecutive rows, run one after another (the reference's ``lax.scan``):
    their gradients summed in float32 and divided by ``grad_accum``, their
    losses averaged, so activation memory scales 1/accum at the same math
    (the optimizer sees the mean gradient)."""

    def train_step(params, opt_state, tokens, labels):
        if grad_accum == 1:
            loss, grads = value_and_grad(lambda p: tf.loss_fn(cfg, p, tokens, labels), params)
        else:
            b = tokens.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")
            mb = b // grad_accum
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(grad_accum):
                t, lab = tokens[i * mb : (i + 1) * mb], labels[i * mb : (i + 1) * mb]
                loss_i, g = value_and_grad(lambda p: tf.loss_fn(cfg, p, t, lab), params)  # noqa: B023
                tree_map(lambda acc, x: acc.add_(x), gsum, g)
                lsum += loss_i
                del g
            grads = tree_map(lambda g: g.div_(grad_accum), gsum)  # in place: no second float32 copy
            loss = lsum / grad_accum
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, lr=3e-4)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    return train_step


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
