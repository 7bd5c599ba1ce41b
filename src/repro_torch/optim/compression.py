"""Gradient compression with error feedback (distributed-optimization trick).

The port of ``repro.optim.compression``: int8 stochastic-rounding
quantization of gradients before the data-parallel all-reduce, with
per-tensor scales and an error-feedback accumulator so the quantization
bias does not accumulate across steps.  The rounding noise is drawn from an
explicit ``torch.Generator`` where the reference splits a JAX key; a
generator's draws differ from JAX's, so the two packages agree on the
function, not on the noise.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


def quantize_int8(x: Tensor, generator: torch.Generator | None):
    """(q int8, scale): ``round(x / scale + U(-0.5, 0.5))`` clipped to ±127,
    scale = max|x| / 127 (at least 1e-12 / 127)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    scaled = x / scale
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, errors, generator: torch.Generator | None):
    """Returns (quantized tree, scales tree, new error-feedback tree)."""
    leaves = tree_leaves(grads)
    err_leaves = tree_leaves(errors) if errors is not None else [0.0] * len(leaves)
    qs, scales, new_errs = [], [], []
    for g, e in zip(leaves, err_leaves):
        corrected = g.float() + e
        q, s = quantize_int8(corrected, generator)
        qs.append(q)
        scales.append(s)
        new_errs.append(corrected - dequantize_int8(q, s))
    return (tree_unflatten(grads, qs), tree_unflatten(grads, scales), tree_unflatten(grads, new_errs))


def decompress_grads(qs, scales):
    return tree_map(dequantize_int8, qs, scales)


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
