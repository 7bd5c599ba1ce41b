"""AdamW with global-norm clipping over parameter trees.

The port of ``repro.optim.adamw``: the same update, the clip scale, the
bias corrections and every moment in float32.  Trees are nested dicts (keys
in sorted order, as JAX flattens them), lists and tuples of tensors;
:func:`tree_leaves`, :func:`tree_map` and :func:`tree_unflatten` walk them
in that order, so the gradient norm sums the leaves in the reference's
order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: Tensor  # int32 []
    mu: Any
    nu: Any


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep ``leaves`` (a step's parameters or
    # moments) alive until the collector's next full pass
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_build(x, it) for x in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn, tree, *rest):
    flat = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def adamw_init(params) -> AdamWState:
    ref = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=ref.device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: float | Tensor = 1e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
):
    """(new params, new state, the gradient's global norm before the clip)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / c1, v / c2
        pf = p.float()
        new_p = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                                  tree_leaves(state.nu))]
    return (tree_unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, mu=tree_unflatten(params, [o[1] for o in out]),
                       nu=tree_unflatten(params, [o[2] for o in out])),
            gnorm)
