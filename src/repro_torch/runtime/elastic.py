"""Elastic scaling: resize the data axis and reshard state deterministically.

The port of ``repro/runtime/elastic.py``.  Losing a card (or adding one
back) changes the device count; work continues by rebuilding the mesh from
the surviving devices and placing the state onto it.  Checkpoints store
*global* arrays, so resharding is a split of each leaf along its spec — no
shard surgery.  :func:`build_mesh`, :func:`shrink_after_failure` and
:func:`split_global_batch` take the reference's ``(data, model)`` and
``(pod, data, model)`` meshes (``launch/mesh.Mesh``); :func:`reshard`
places a tree by its logical-axis specs through ``runtime/mesh_rules``, or,
given an engine state and a ``DataMesh``, is the engine's own placement
(:func:`repro_torch.core.engine.reshard`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import mesh_rules


def build_mesh(devices=None, *, data: int | None = None, model: int | None = None,
               pod: int | None = None, emulate: bool = False) -> mesh_lib.Mesh:
    """The reference's largest rectangular mesh over ``devices`` (default:
    every visible card): ``(pod, data, model)`` with ``pod``, else
    ``(data, model)`` with ``model`` defaulting to the largest divisor of
    the device count at most its square root.  Devices that repeat are
    coordinates emulated on one device, and only with ``emulate=True``."""
    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if pod:
        shape, axes = (pod, data or 1, model or 1), ("pod", "data", "model")
    else:
        if model is None:
            model = min(n, int(np.sqrt(n)))
            while model > 1 and n % model:
                model -= 1
        data = data or n // max(model, 1)
        shape, axes = (data, model), ("data", "model")
    need = math.prod(shape)
    if not 1 <= need <= n:
        raise ValueError(f"a mesh of shape {shape} over {n} device(s)")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return mesh_lib.Mesh(arr.reshape(shape), axes, emulated=emulate)


def reshard(tree, specs_tree, new_mesh=None):
    """Place ``tree`` onto ``new_mesh`` by its logical-axis specs
    (``mesh_rules.shardings_for``): a tree of
    :class:`~repro_torch.runtime.mesh_rules.Placed` blocks.

    ``reshard(state, data_mesh)`` — an engine state and a ``DataMesh`` —
    is the engine's placement, one state per shard."""
    if new_mesh is None:
        return engine_lib.reshard(tree, specs_tree)
    shardings = mesh_rules.shardings_for(specs_tree, new_mesh)

    def walk(x, s):
        if isinstance(s, mesh_rules.NamedSharding):
            return s.place(x)
        if isinstance(s, dict):
            return {k: walk(x[k], s[k]) for k in s}
        return type(s)(walk(a, b) for a, b in zip(x, s))

    return walk(tree, shardings)


def shrink_after_failure(mesh, failed_devices: set):
    """The mesh without its failed devices.  A ``Mesh`` keeps its ``model``
    extent and shrinks ``data`` to the survivors (the reference's); a
    ``DataMesh`` keeps its surviving shards."""
    failed = {mesh_lib.canonical(d) for d in failed_devices}
    if isinstance(mesh, mesh_lib.DataMesh):
        survivors = tuple(d for d in mesh.devices if d not in failed)
        if not survivors:
            raise ValueError("no device survives: the mesh cannot shrink to zero shards")
        return mesh_lib.DataMesh(survivors, emulated=mesh.emulated)
    survivors = [d for d in mesh.devices.flat if d not in failed]
    model = mesh.devices.shape[-1]
    data = len(survivors) // model
    if data < 1:
        raise ValueError("not enough devices survive for one model replica")
    return build_mesh(survivors, data=data, model=model, emulate=mesh.emulated)


def split_global_batch(global_batch: int, mesh) -> int:
    """Per-replica batch under the current ``pod`` x ``data`` extent (must
    divide)."""
    dp = math.prod(n for a, n in mesh.shape.items() if a in ("pod", "data"))
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} does not split over {dp} data replicas")
    return global_batch // dp
