"""Device meshes of the port: the vertex-sharded sweep's ``data`` axis.

The port of ``repro/launch/mesh.py``.  JAX's ``shard_map`` is one
controller driving many devices; so is the port: one Python process holds a
:class:`DataMesh` of N devices along the ``data`` axis, keeps shard ``k``'s
tensors on ``mesh.devices[k]`` and exchanges them through the plain
collectives below (no ``torch.distributed``).

N shards on ONE device exist only where the caller asks for them
(``make_data_mesh(n, emulate=True)``, the CLIs' ``--emulate-devices N``):
the port's counterpart of the reference's host-device flag, which is how the
CPU tests and the card's smoke run shards.  Over distinct devices,
:func:`make_data_mesh` raises when fewer than n are visible.

Replicated leaves (the Bloom bits, the selection rows, the loop scalars) are
held once per distinct device: shards emulated on one device share them.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def canonical(device) -> torch.device:
    """``device`` as tensors placed there report it (a bare "cuda" is card 0)."""
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """N devices along the ``data`` axis; shard ``k`` lives on
    ``devices[k]``.  ``emulated``: the shards share one device."""

    devices: tuple[torch.device, ...]
    emulated: bool = False

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(canonical(d) for d in self.devices))
        if not self.emulated and len(set(self.devices)) != len(self.devices):
            raise ValueError(f"mesh devices repeat without emulate=True: {self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)


def mesh_device(mesh, device=None) -> torch.device:
    """The device of a sharded engine or session: the mesh's first.  A
    ``mesh`` that is not a :class:`DataMesh` raises TypeError, a ``device``
    that is not its first device ValueError."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.DataMesh, not {type(mesh).__name__}")
    if device is not None and canonical(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device {mesh.devices[0]}")
    return mesh.devices[0]



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


def make_production_mesh(*, multi_pod: bool = False) -> DataMesh:
    """The reference's production extent (256 devices a pod, 512 with
    ``multi_pod``) along the data axis; raises unless that many cards are
    visible."""
    return make_data_mesh(512 if multi_pod else 256)


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
