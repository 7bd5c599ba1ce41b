"""Architecture registry protocol of the port.

Every architecture module exposes an :class:`ArchSpec` as the reference's
``repro/configs/common.py`` does: ``name``, ``family``, ``full`` (the
published widths), ``smoke`` (a reduced config for CPU tests), ``shapes``
(the assigned input shapes) and ``notes``.  The reference's ``build_cell``,
``Cell`` and sharding helpers lower jitted cells on a mesh for its dry-run;
the port runs its cells directly (``configs/lm_harness.py``).
:func:`value_and_grad` is what the train steps take their gradients with.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    kind: str  # train | prefill | decode | serve | retrieval
    meta: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    shapes: dict
    notes: str = ""


def value_and_grad(loss_fn, params):
    """``(loss, grads)``: ``loss_fn(params)`` detached and its gradient by
    autograd as a tree of ``params``' structure (the reference's
    ``jax.value_and_grad``); a leaf the loss does not reach gets zeros."""
    from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [torch.zeros_like(x) if g is None else g
                                                  for x, g in zip(leaves, grads)])
