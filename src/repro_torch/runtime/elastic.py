"""Elastic scaling: resize the data axis and reshard state deterministically.

The port of ``repro/runtime/elastic.py`` for the vertex-sharded engine.
Losing a card (or adding one back) changes the device count; serving
continues by rebuilding the :class:`~repro_torch.launch.mesh.DataMesh` from
the surviving devices and placing the engine state onto it.  Checkpoints
store *global* arrays (``DiffIFE.export_state``), so resharding is a split
of each leaf along its key axis — no shard surgery — and is the engine's
own placement, :func:`repro_torch.core.engine.reshard`.  The reference's
``mesh_rules`` (logical axes → partition specs for the models) has no
counterpart yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import reshard  # noqa: F401  (the engine's placement, re-exported)
from repro_torch.launch import mesh as mesh_lib


def build_mesh(devices=None, *, data: int | None = None, emulate: bool = False) -> mesh_lib.DataMesh:
    """A data mesh over the first ``data`` of ``devices`` (default: every
    visible card, all of them).  Devices that repeat are shards emulated on
    one device, and only with ``emulate=True``."""
    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    n = len(devices) if data is None else int(data)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a data axis of {n} over {len(devices)} device(s)")
    return mesh_lib.DataMesh(tuple(devices[:n]), emulated=emulate)


def shrink_after_failure(mesh: mesh_lib.DataMesh, failed_devices: set) -> mesh_lib.DataMesh:
    """The mesh without its shards on ``failed_devices``; the data axis
    shrinks to the survivors."""
    failed = {mesh_lib.canonical(d) for d in failed_devices}
    survivors = tuple(d for d in mesh.devices if d not in failed)
    if not survivors:
        raise ValueError("no device survives: the mesh cannot shrink to zero shards")
    return mesh_lib.DataMesh(survivors, emulated=mesh.emulated)


def split_global_batch(global_batch: int, mesh: mesh_lib.DataMesh) -> int:
    """Per-shard batch under the current data extent (must divide)."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} does not split over {mesh.size} shards")
    return global_batch // mesh.size
