"""Architecture registry protocol of the port, and the dry-run's cells.

Every architecture module exposes an :class:`ArchSpec` as the reference's
``repro/configs/common.py`` does: ``name``, ``family``, ``full`` (the
published widths), ``smoke`` (a reduced config for CPU tests), ``shapes``
(the assigned input shapes), ``build_cell`` and ``notes``.

``build_cell(cfg, shape, mesh)`` returns a :class:`Cell`: the step function,
its arguments as tensors on the ``meta`` device (the counterpart of the
reference's ``ShapeDtypeStruct``\\ s: shapes and dtypes, no storage) and
their shardings on ``mesh`` (``runtime/mesh_rules.NamedSharding``).  The
reference lowers a cell with ``jax.jit``; the port has no compiler, so a
cell offers what the dry-run (``launch/dryrun.py``) and the card need in
its place: :meth:`Cell.per_device_bytes` (what each device holds of the
arguments) and :meth:`Cell.materialize` (real arguments on a device).
:func:`value_and_grad` is what the train steps take their gradients with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.runtime import mesh_rules
from repro_torch.runtime.mesh_rules import NamedSharding


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    kind: str  # train | prefill | decode | serve | retrieval | maintain
    meta: dict


@dataclasses.dataclass
class Cell:
    """One (arch × shape) dry-run unit.

    ``args`` are meta tensors in the step's argument tree and
    ``in_shardings`` a tree of the same structure with a
    :class:`NamedSharding` for each tensor.  ``make_args(device,
    generator)`` builds real arguments (for ``diff-ife``: a valid engine
    state, a graph and its dirty mask); ``dry_fn`` is what the dry-run counts in place of
    ``fn`` where ``fn`` cannot run on the meta device (``diff-ife``'s sweep
    reads its frontier on the host every iteration)."""

    name: str
    fn: Callable
    args: tuple
    in_shardings: Any
    model_flops: float = 0.0  # 6·N·D (dense) / 6·N_active·D (MoE); 0 = n/a
    mesh: Any = None
    make_args: Callable | None = None
    dry_fn: Callable | None = None

    def per_device_bytes(self) -> int:
        """The largest per-device sum of the arguments' bytes under their
        shardings.  Splits are even, so every device holds a block of the
        same shape of each argument and this is what each one holds."""
        return sum(math.prod(sh.shard_shape(x.shape)) * x.element_size()
                   for x, sh in leaves_with_shardings(self.args, self.in_shardings))

    def materialize(self, device, generator: torch.Generator) -> tuple:
        """Real arguments on ``device``: the cell's ``make_args(device,
        generator)``.  A cell without one raises."""
        if self.make_args is None:
            raise ValueError(f"cell {self.name!r} has no make_args to draw real arguments with")
        return self.make_args(device, generator)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    shapes: dict
    build_cell: Callable[[Any, str, Any], Cell]
    notes: str = ""


def named(mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, mesh_rules.logical_to_spec(axes, mesh))


def batch_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, mesh_rules.shard_batch_spec(mesh))


def replicated(mesh) -> NamedSharding:
    return mesh_rules.replicated(mesh)


def tree_struct(fn, *args, **kw):
    """``fn(*args, **kw)`` run under ``torch.device("meta")``: its tree of
    meta tensors (shapes and dtypes, no allocation; the reference's
    ``eval_shape``).  Code that names its device must be given ``meta``."""
    with torch.device("meta"):
        return fn(*args, **kw)


def map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and named
    tuples; other leaves (``None``, Python numbers) stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def leaves_with_shardings(args, shardings) -> list[tuple[torch.Tensor, NamedSharding]]:
    """Every tensor of ``args`` with the sharding at its place in
    ``shardings`` (a tree of the same structure, or one sharding for a whole
    subtree).  A tensor without one raises."""
    out: list = []

    def walk(a, s):
        if isinstance(s, NamedSharding):
            for x in _tensors(a):
                out.append((x, s))
        elif isinstance(a, torch.Tensor):
            raise ValueError(f"a {tuple(a.shape)} {a.dtype} argument has no sharding ({s!r})")
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        elif isinstance(a, (list, tuple)):
            if s is None or len(s) != len(a):
                raise ValueError(f"shardings {s!r} do not match an argument of {len(a)} entries")
            for x, y in zip(a, s):
                walk(x, y)

    walk(args, shardings)
    return out


def _tensors(tree) -> list[torch.Tensor]:
    out: list = []
    map_tensors(out.append, tree)
    return out


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
