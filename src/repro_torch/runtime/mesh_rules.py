"""Logical-axis → mesh-axis rules (MaxText-style) and placement on a mesh.

The port of ``repro/runtime/mesh_rules.py``.  Model code names every
parameter and cache axis by a *logical* axis (``models/transformer.
param_specs``, ``cache_specs``); this module resolves those names against a
mesh (``launch/mesh.Mesh``, or a ``DataMesh`` read as ``(n, 1)``) with the
reference's rules: the first option whose mesh axes are all present wins,
one mesh axis appears at most once in a spec, and axes absent from the mesh
resolve to replicated.

A spec (:class:`PartitionSpec`) is a tuple with one entry a tensor axis: a
mesh-axis name, a tuple of names (the axis split over their product,
row-major) or ``None``.  Where the reference hands a ``NamedSharding`` to
XLA, the port's :class:`NamedSharding` says which block of a global tensor
each mesh coordinate holds and puts it there (:meth:`NamedSharding.place`):
a view of the tensor where the coordinate's device is the tensor's own (so
blocks on an emulated mesh are views of one tensor), a copy on another
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


class PartitionSpec(tuple):
    """One entry a tensor axis: a mesh-axis name, a tuple of names, or
    ``None`` (replicated).  Equal to the plain tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# logical name → preferred mesh axes, first present wins; tuples shard one
# logical dim over multiple mesh axes (the reference's table)
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), ("data",)),  # DP over pod×data
    "layers": ((),),  # never sharded
    "embed": (("data",),),  # FSDP param shard
    "heads": (("model",),),  # TP
    "mlp": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),  # EP
    "kv_seq": (("model",),),  # decode cache: sequence-parallel KV
    "table_rows": (("model",),),  # recsys embedding rows
    "graph_nodes": (("model",),),  # GNN node states
    "graph_edges": (("pod", "data"), ("data",)),  # edge-parallel
    "q_vertices": (("pod", "data"), ("data",)),  # DC: concurrent queries
    "dc_vertices": (("model",),),  # DC: vertex/store axis
    "q_all": (("pod", "data", "model"), ("data", "model")),  # DC: queries over the whole mesh
    "dc_local": ((),),  # vertex axis replicated (per-device full graph)
    "seq": ((),),  # activations: seq replicated
}


def resolve_axis(logical: str | None, mesh) -> tuple | str | None:
    """The mesh axes ``logical`` shards over on ``mesh``: a name, a tuple of
    names, or ``None`` (replicated; an unknown name too)."""
    if logical is None:
        return None
    for opt in DEFAULT_RULES.get(logical, ((),)):
        if isinstance(opt, tuple) and len(opt) and isinstance(opt[0], tuple):
            opt = opt[0]
        if all(a in mesh.axis_names for a in opt):
            if len(opt) == 0:
                return None
            return opt if len(opt) > 1 else opt[0]
    return None


def logical_to_spec(axes: tuple, mesh) -> PartitionSpec:
    """('layers', 'embed', 'heads') → the spec for this mesh; a mesh axis
    already used by an earlier entry leaves a later one replicated."""
    used: set = set()
    parts = []
    for ax in axes:
        r = resolve_axis(ax, mesh)
        if r is None:
            parts.append(None)
            continue
        rs = r if isinstance(r, tuple) else (r,)
        if any(a in used for a in rs):
            parts.append(None)
            continue
        used.update(rs)
        parts.append(r)
    return P(*parts)


def _is_axes_leaf(x) -> bool:
    # a PartitionSpec may hold tuples of names: a leaf all the same
    if isinstance(x, PartitionSpec):
        return True
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _clip_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop mesh axes the target mesh doesn't have (elastic restore)."""
    return P(*(ax if ax in mesh.axis_names else None for ax in spec))


def grid(mesh) -> np.ndarray:
    """The mesh's devices as an object array of its shape (a ``DataMesh``
    as ``(n, 1)``)."""
    devs = mesh.devices
    if isinstance(devs, np.ndarray):
        return devs
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr.reshape(tuple(mesh.shape.values()))


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``spec`` on ``mesh``: tensor axis ``i`` split into as many equal
    blocks as its entry's mesh axes have coordinates, every other mesh axis
    holding the same block (replicated)."""

    mesh: object
    spec: PartitionSpec

    def _index(self, shape, coord: tuple) -> tuple:
        """The slices of the block at mesh coordinate ``coord``."""
        sizes = self.mesh.shape
        where = dict(zip(self.mesh.axis_names, coord))
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            if entry is None:
                out.append(slice(None))
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            parts = math.prod(sizes[a] for a in names)
            if n % parts:
                raise ValueError(f"axis {i} of extent {n} does not split into {parts} blocks over {names}")
            k = 0
            for a in names:  # row-major over the entry's axes
                k = k * sizes[a] + where[a]
            step = n // parts
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of the block each coordinate holds of a global
        ``shape`` (JAX's ``NamedSharding.shard_shape``): every coordinate's
        block has it, as the splits are even (an uneven one raises)."""
        idx = self._index(tuple(shape), (0,) * len(self.mesh.axis_names))
        return tuple(n if s.start is None else s.stop - s.start for s, n in zip(idx, shape))

    def place(self, x) -> "Placed":
        """Every mesh coordinate's block of the global ``x`` on its device:
        a view where the device is ``x``'s own, one copy a distinct
        (device, block) otherwise."""
        t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
        devs = grid(self.mesh)
        copies: dict = {}
        blocks = {}
        for coord in np.ndindex(devs.shape):
            idx = self._index(t.shape, coord)
            key = (devs[coord], tuple((s.start, s.stop) for s in idx))
            if key not in copies:
                copies[key] = t[idx].to(devs[coord])
            blocks[coord] = copies[key]
        return Placed(self, tuple(t.shape), t.dtype, blocks)


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A global tensor placed by ``sharding``: ``blocks`` maps each mesh
    coordinate to the block it holds."""

    sharding: NamedSharding
    shape: tuple
    dtype: torch.dtype
    blocks: dict

    def gather(self, device=None) -> Tensor:
        """The global tensor, assembled from the blocks on ``device``
        (default: the first coordinate's)."""
        first = next(iter(self.blocks.values()))
        device = first.device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for coord, b in self.blocks.items():
            out[self.sharding._index(self.shape, coord)] = b.to(device)
        return out


def tree_map(fn, tree, is_leaf):
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def shardings_for(specs_tree, mesh):
    """A tree of logical-axis tuples (or raw :class:`PartitionSpec`\\ s) as
    :class:`NamedSharding`\\ s on ``mesh``.  Raw specs pass through, clipped
    to the mesh's axes, as the reference's do."""

    def to_sharding(axes):
        if isinstance(axes, PartitionSpec):
            return NamedSharding(mesh, _clip_spec(axes, mesh))
        return NamedSharding(mesh, logical_to_spec(axes, mesh))

    return tree_map(to_sharding, specs_tree, _is_axes_leaf)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_spec(mesh) -> PartitionSpec:
    ax = resolve_axis("batch", mesh)
    return P(ax) if ax is not None else P()
