"""Step functions for the LM-family architectures: the port of
``repro/configs/lm_harness.py``'s train, prefill and serve steps.

Shapes (assigned): train_4k (train_step), prefill_32k (prefill), decode_32k
(serve_step: 1 new token against a seq_len KV cache).  :func:`build_lm_cell`
is the reference's: the step, its arguments as meta tensors and their
shardings (``transformer.param_specs``/``cache_specs`` resolved on the
mesh).  The port runs the steps on one device, and a decode step under
``models.common.activation_mesh`` of a mesh with a ``model`` axis splits
its cache over that axis (the ``dlse`` attentions).  Splitting the products
over cards (the reference's tensor and expert parallelism) is not ported
(ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import (
    Cell,
    ShapeDef,
    batch_sharding,
    replicated,
    tree_struct,
    value_and_grad,
)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import AdamWState, adamw_init, tree_map
from repro_torch.runtime import mesh_rules

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


# microbatches of the train shape, the reference's: chosen so a step fits a
# 16 GB chip (arctic's MoE dispatch buffers dominate, minicpm3 saves 62
# layers of residuals)
GRAD_ACCUM = {"qwen2-72b": 16, "arctic-480b": 32, "minicpm3-4b": 8, "qwen2-moe-a2.7b": 8}


def param_structs(cfg: tf.TransformerConfig):
    return tf.init_params(cfg, None, device="meta")


def param_shardings(cfg: tf.TransformerConfig, mesh):
    return mesh_rules.shardings_for(tf.param_specs(cfg), mesh)


def opt_structs(cfg: tf.TransformerConfig):
    return tree_struct(adamw_init, param_structs(cfg))


def opt_shardings(cfg: tf.TransformerConfig, mesh) -> AdamWState:
    psh = param_shardings(cfg, mesh)
    return AdamWState(step=replicated(mesh), mu=psh, nu=psh)


def _tokens(b: int, s: int | None = None) -> torch.Tensor:
    return torch.empty((b,) if s is None else (b, s), dtype=torch.int32, device="meta")


def build_lm_cell(cfg: tf.TransformerConfig, shape_name: str, mesh) -> Cell:
    """The (arch × shape) cell of an LM: train (with the reference's
    :data:`GRAD_ACCUM`), prefill or decode, its meta arguments and their
    shardings; ``model_flops`` 6·N_active·tokens."""
    shape = LM_SHAPES[shape_name]
    b, s = shape.meta["global_batch"], shape.meta["seq_len"]
    ps, psh, bsh = param_structs(cfg), param_shardings(cfg, mesh), batch_sharding(mesh)
    model_flops = 6.0 * cfg.num_active_params() * b * s
    name = f"{cfg.name}:{shape_name}"

    if shape.kind == "train":
        fn = make_train_step(cfg, grad_accum=GRAD_ACCUM.get(cfg.name, 1))
        args = (ps, opt_structs(cfg), _tokens(b, s), _tokens(b, s))
        in_sh = (psh, opt_shardings(cfg, mesh), bsh, bsh)
        return Cell(name, fn, args, in_sh, model_flops=model_flops, mesh=mesh)

    if shape.kind == "prefill":
        return Cell(name, make_prefill(cfg), (ps, _tokens(b, s)), (psh, bsh), model_flops=model_flops,
                    mesh=mesh)

    if shape.kind == "decode":
        cache = tf.init_cache(cfg, b, s, device="meta")
        cache_sh = mesh_rules.shardings_for(tf.cache_specs(cfg), mesh)
        args = (ps, cache, _tokens(b), _tokens(b))
        # decode model flops: one token per sequence
        return Cell(name, make_decode(cfg), args, (psh, cache_sh, bsh, bsh),
                    model_flops=6.0 * cfg.num_active_params() * b, mesh=mesh)

    raise ValueError(shape.kind)

