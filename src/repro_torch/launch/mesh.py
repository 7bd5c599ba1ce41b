"""Device meshes of the port: named axes, and the vertex-sharded sweep's
``data`` axis.

The port of ``repro/launch/mesh.py``.  JAX's ``shard_map`` is one
controller driving many devices; so is the port: one Python process holds a
mesh, keeps each shard's tensors on its device and exchanges them through
the plain collectives below (no ``torch.distributed``).

:class:`Mesh` is the reference's mesh: devices on named axes, ``("data",
"model")`` or ``("pod", "data", "model")``, with its ``shape`` and
``axis_names``.  ``runtime/mesh_rules`` resolves logical axes against it,
and the models' decode attentions split the cache over its ``model`` axis
(``models/common.dlse_*``).  :class:`DataMesh` is its ``data`` axis alone,
which is what the engine shards vertices over: a :class:`Mesh` given to the
engine, a session or a server becomes :func:`as_data_mesh` of it, the
devices along ``data`` at the first ``pod`` and ``model`` coordinate, as the
reference's engine shards over ``mesh.shape["data"]`` and replicates over
``model`` (a one-controller port computes each vertex block once).

Several shards on ONE device exist only where the caller asks for them
(``emulate=True``, the CLIs' ``--emulate-devices N``): the port's
counterpart of the reference's host-device flag, which is how the CPU tests
and the card's smoke run meshes.  Over distinct devices the constructors
raise when fewer are visible.

Replicated leaves (the Bloom bits, the selection rows, the loop scalars) are
held once per distinct device: shards emulated on one device share them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


# a torch.device's index is 8 bits: the cards one process can name
MAX_DEVICES = 128


def canonical(device) -> torch.device:
    """``device`` as tensors placed there report it (a bare "cuda" is card 0)."""
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """N devices along the ``data`` axis; shard ``k`` lives on
    ``devices[k]``.  ``emulated``: the shards share one device.  Its
    ``shape`` and ``axis_names`` read as the reference's ``(n, 1)``
    ``("data", "model")`` mesh."""

    devices: tuple[torch.device, ...]
    emulated: bool = False
    # read as the reference's (n, 1) data mesh
    axis_names = ("data", "model")

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(canonical(d) for d in self.devices))
        if not self.emulated and len(set(self.devices)) != len(self.devices):
            raise ValueError(f"mesh devices repeat without emulate=True: {self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "model": 1}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on named axes, as the reference's ``jax.sharding.Mesh``:
    ``devices`` an object array of ``torch.device`` whose shape is the
    axes' extents, ``axis_names`` their names, ``shape`` name -> extent.
    ``emulated``: devices repeat (shards emulated on one device)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    emulated: bool = False

    def __post_init__(self):
        devs = np.empty(np.shape(self.devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            devs[idx] = canonical(d)
        if devs.ndim != len(self.axis_names) or len(set(self.axis_names)) != devs.ndim:
            raise ValueError(f"a mesh of shape {devs.shape} with axes {self.axis_names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        if not self.emulated and len(set(devs.flat)) != devs.size:
            raise ValueError(f"mesh devices repeat without emulate=True: {tuple(devs.flat)}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, **coords) -> torch.device:
        """The device at the given axis coordinates (the rest at 0)."""
        return self.devices[tuple(int(coords.get(a, 0)) for a in self.axis_names)]


def as_data_mesh(mesh) -> DataMesh:
    """The engine's mesh: a :class:`DataMesh` as it is, a :class:`Mesh`'s
    ``data`` axis at its first ``pod`` and ``model`` coordinate (a mesh
    without a ``data`` axis is one shard).  Anything else raises
    TypeError."""
    if isinstance(mesh, DataMesh):
        return mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.DataMesh or Mesh, not {type(mesh).__name__}")
    n = mesh.shape.get("data", 1)
    devs = tuple(mesh.device_at(data=k) for k in range(n))
    return DataMesh(devs, emulated=mesh.emulated and len(set(devs)) < n)


def mesh_device(mesh, device=None) -> torch.device:
    """The device of a sharded engine or session: the first of the mesh's
    ``data`` axis (:func:`as_data_mesh`).  A ``mesh`` that is neither a
    :class:`DataMesh` nor a :class:`Mesh` raises TypeError, a ``device``
    that is not its first device ValueError."""
    first = as_data_mesh(mesh).devices[0]
    if device is not None and canonical(device) != first:
        raise ValueError(f"device {device} is not the mesh's first device {first}")
    return first



def _visible(kind: str) -> int:
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"no mesh over {kind!r} devices")


def make_data_mesh(num_shards: int | None = None, *, device=None, emulate: bool = False) -> DataMesh:
    """A ``data`` mesh of ``num_shards`` shards.

    Without ``emulate``: one shard per distinct device of ``device``'s kind
    (default CUDA), ``cuda:0..n-1``; ``num_shards=None`` takes every visible
    card, and asking for more than are visible raises.  With ``emulate``:
    ``num_shards`` shards on the one device ``device`` (default
    ``cuda:0``) — shards in name, one device in fact.
    """
    dev = canonical("cuda" if device is None else device)
    if emulate:
        if num_shards is None or int(num_shards) < 1:
            raise ValueError("an emulated mesh needs num_shards >= 1")
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {dev}")
        return DataMesh((dev,) * int(num_shards), emulated=True)
    visible = _visible(dev.type)
    n = visible if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"asked for {n} shards")
    if n > visible:
        raise ValueError(
            f"asked for {n} shards but only {visible} {dev.type} device(s) are visible "
            "(emulate=True places several shards on one device)"
        )
    if dev.type == "cpu":
        return DataMesh((dev,))
    return DataMesh(tuple(torch.device("cuda", k) for k in range(n)))


def make_smoke_mesh(device=None) -> DataMesh:
    """One shard on one device (smoke runs)."""
    dev = canonical("cuda" if device is None else device)
    _visible(dev.type)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"no CUDA device {dev}")
    return DataMesh((dev,))


def make_mesh(shape, axis_names, *, device=None, emulate: bool = False) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axis_names``.

    Without ``emulate``: one distinct device of ``device``'s kind (default
    CUDA) a coordinate, ``cuda:0..n-1`` in row-major order; raises when
    fewer are visible.  With ``emulate``: every coordinate on the one
    device ``device`` (default ``cuda:0``)."""
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if n < 1:
        raise ValueError(f"a mesh of shape {shape}")
    dev = canonical("cuda" if device is None else device)
    if emulate:
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {dev}")
        devs = [dev] * n
    else:
        visible = _visible(dev.type)
        if n > visible:
            raise ValueError(
                f"a mesh of shape {shape} needs {n} devices but only {visible} {dev.type} device(s) "
                "are visible (emulate=True places several coordinates on one device)"
            )
        if n > MAX_DEVICES:
            raise ValueError(
                f"a mesh of shape {shape} needs {n} cards, but a torch.device names at most "
                f"{MAX_DEVICES} in one process (emulate=True places the coordinates on one device)"
            )
        devs = [dev] if dev.type == "cpu" else [torch.device("cuda", k) for k in range(n)]
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names), emulated=emulate and n > 1)


# the reference's production mesh, by ``multi_pod``
PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16 x 16 = 256 cards over
    ``("data", "model")``, 2 x 16 x 16 = 512 over ``("pod", "data",
    "model")`` with ``multi_pod`` (:data:`PRODUCTION_SHAPE`,
    :data:`PRODUCTION_AXES`).  It raises unless that many cards are
    visible, and a process names at most :data:`MAX_DEVICES`, so only a
    multi-process runtime could hold it.  The engine shards vertices over
    its ``data`` axis (16) and replicates them over ``model``."""
    return make_mesh(PRODUCTION_SHAPE[multi_pod], PRODUCTION_AXES[multi_pod])


# --------------------------------------------------------------------------- placement
@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a global array goes on a mesh: split into equal blocks along
    ``axis`` (shard k takes block k), or replicated (``axis=None``: one copy
    per distinct device, shared by the shards on it)."""

    mesh: DataMesh
    axis: int | None = None

    def place(self, x) -> list[Tensor]:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if self.axis is None:
            return replicate(t, self.mesh.devices)
        n = self.mesh.size
        if t.shape[self.axis] % n:
            raise ValueError(f"axis {self.axis} of extent {t.shape[self.axis]} does not split into {n} shards")
        return [p.to(d, copy=True).contiguous() for p, d in zip(t.chunk(n, dim=self.axis), self.mesh.devices)]


def _per_device(devices, make) -> list:
    """``make(device)`` once per distinct device, in shard order."""
    cache: dict = {}
    out = []
    for d in devices:
        if d not in cache:
            cache[d] = make(d)
        out.append(cache[d])
    return out


def replicate(x: Tensor, devices) -> list[Tensor]:
    """A copy of ``x`` per distinct device (shards on one device share it)."""
    return _per_device(devices, lambda d: x.to(d, copy=True))


# --------------------------------------------------------------------------- collectives
def all_gather(parts: list[Tensor], devices, dim: int = -1) -> list[Tensor]:
    """The shards' blocks concatenated along ``dim``, on every shard's
    device (once per distinct device).  One shard: its block itself."""
    if len(parts) == 1:
        return list(parts)
    return _per_device(devices, lambda d: torch.cat([p.to(d) for p in parts], dim=dim))


def _reduce(parts: list[Tensor], devices, op) -> list[Tensor]:
    if len(parts) == 1:
        return list(parts)

    def make(d):
        acc = parts[0].to(d)
        for p in parts[1:]:
            acc = op(acc, p.to(d))
        return acc

    return _per_device(devices, make)


def psum(parts: list[Tensor], devices) -> list[Tensor]:
    """Elementwise sum of the shards' tensors, on every shard's device."""
    return _reduce(parts, devices, torch.add)


def pmax(parts: list[Tensor], devices) -> list[Tensor]:
    """Elementwise max of the shards' tensors, on every shard's device."""
    return _reduce(parts, devices, torch.maximum)


def por(parts: list[Tensor], devices) -> list[Tensor]:
    """Elementwise OR of the shards' bool tensors, on every shard's device."""
    return _reduce(parts, devices, torch.logical_or)
