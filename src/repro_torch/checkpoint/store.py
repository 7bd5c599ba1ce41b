"""Checkpoint store: per-leaf npz shards + a JSON manifest.

The port of ``repro/checkpoint/store.py``, with its on-disk format, so a
checkpoint written by either package loads in the other:

  * ``<dir>/step_XXXXXXXX/manifest.json`` — ``{"step", "leaves": {key:
    {"shape", "dtype"}}, "meta"?}``; ``shard_0.npz`` holds every leaf under
    its key with ``/`` written as ``__``.
  * **atomic**: writes land in ``step_XXXXXXXX.tmp`` and are renamed only
    after the shard and the manifest are fsynced — a crash mid-write never
    corrupts the latest checkpoint.
  * **async**: :class:`CheckpointManager` moves serialization onto a writer
    thread (double-buffered: a save blocks only while the previous write is
    still in flight) and keeps the last N steps.

Leaves are host arrays.  A ``torch.Tensor`` leaf is copied to the host
(``.to("cpu", copy=True)``, synchronous) before any writer thread sees it,
so a later in-place edit of device state never reaches a snapshot.  Trees
are nested dicts (keys sorted), lists, tuples and named tuples (fields by
name); ``None`` holds no leaf.  Key strings are the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import Sharding

Pytree = Any

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index, named tuples by field."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flatten(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [p for f in tree._fields for p in _flatten(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _flatten(x, prefix + (i,))]
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    return [("/".join(str(p) for p in path), leaf) for path, leaf in _flatten(tree)]


def to_host(leaf) -> np.ndarray:
    """A host array of ``leaf``: a tensor is copied off its device (an
    owned copy even on the CPU, where ``.numpy()`` would alias it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    return _unflatten(tree, iter([to_host(x) for _, x in _flatten(tree)]))


def save_checkpoint(directory: str, step: int, tree: Pytree, *,
                    meta: dict | None = None) -> str:
    """Synchronous atomic save; returns the final step dir.

    ``meta`` (JSON-able) rides along in the manifest so a restore can
    rebuild host-side structure (plans, free lists, cursors) before touching
    arrays.
    """
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    if meta is not None:
        manifest["meta"] = meta
    arrays = {}
    for key, leaf in _leaf_paths(tree):
        arr = to_host(leaf)
        arrays[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    npz_path = os.path.join(tmp, "shard_0.npz")
    np.savez(npz_path, **{k.replace("/", "__"): v for k, v in arrays.items()})
    with open(npz_path, "rb+") as f:
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _step_dir(directory: str, step: int | None) -> tuple[str, int]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step:08d}"), step


def load_checkpoint(directory: str, step: int | None = None
                    ) -> tuple[dict[str, np.ndarray], dict, int]:
    """Load a checkpoint's raw leaves keyed by path, plus its manifest.

    Unlike :func:`restore_checkpoint` this needs no target tree — callers
    that must rebuild host structure from ``manifest["meta"]`` before they
    know the tree shape (``CQPSession.restore``) start here.
    """
    d, step = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        arrays = {k: data[k.replace("/", "__")] for k in manifest["leaves"]}
    return arrays, manifest, step


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _validate_leaf(key: str, manifest: dict, target, directory: str) -> None:
    entry = manifest["leaves"].get(key)
    if entry is None:
        raise ValueError(
            f"checkpoint {directory} has no leaf {key!r}; "
            f"saved leaves: {sorted(manifest['leaves'])}"
        )
    shape = tuple(target.shape) if isinstance(target, torch.Tensor) else np.shape(target)
    if tuple(entry["shape"]) != shape:
        raise ValueError(
            f"checkpoint leaf {key!r} has shape {tuple(entry['shape'])} but the "
            f"restore target expects {shape}"
        )
    if entry["dtype"] != str(_np_dtype(target)):
        raise ValueError(
            f"checkpoint leaf {key!r} has dtype {entry['dtype']} but the "
            f"restore target expects {_np_dtype(target)}"
        )


def restore_checkpoint(directory: str, target_tree: Pytree, step: int | None = None,
                       shardings=None) -> tuple[Pytree, int]:
    """Restore into the structure of ``target_tree``.

    Every target leaf is validated against the manifest (presence, shape,
    dtype), so a mismatched tree fails with a named error.  A tensor leaf
    of the target comes back as a tensor on that leaf's device; any other
    leaf as a numpy array.  ``shardings``, a tree of the target's structure
    with a :class:`~repro_torch.launch.mesh.Sharding` at every leaf, places
    the restored leaves onto a mesh instead: each comes back as the list of
    its shards' tensors (split along the sharding's axis, or replicated).
    """
    d, step = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        for key, target in _leaf_paths(target_tree):
            _validate_leaf(key, manifest, target, d)
            arr = data[key.replace("/", "__")]
            if isinstance(target, torch.Tensor):
                arr = torch.from_numpy(arr).to(target.device)
            leaves.append(arr)
    if shardings is not None:
        specs = [s for _, s in _flatten(shardings)]
        if len(specs) != len(leaves) or not all(isinstance(s, Sharding) for s in specs):
            raise ValueError("shardings must match the target tree with a Sharding at every leaf")
        leaves = [s.place(x) for x, s in zip(leaves, specs)]
    return _unflatten(target_tree, iter(leaves)), step


class CheckpointManager:
    """Async keep-N checkpoint manager.

    ``wait_s`` records, per :meth:`save`, how long the caller blocked on the
    previous write; ``write_s`` each write's own seconds (serialization,
    fsync and GC, on the writer thread when async)."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self.wait_s: list[float] = []
        self.write_s: list[float] = []
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Pytree, *, meta: dict | None = None) -> None:
        host_tree = _host_tree(tree)
        if self.async_write:
            t0 = time.perf_counter()
            self.wait()  # double buffer: at most one write in flight
            self.wait_s.append(time.perf_counter() - t0)
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, meta), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host_tree, meta)

    def _write(self, step: int, tree: Pytree, meta: dict | None = None) -> None:
        t0 = time.perf_counter()
        save_checkpoint(self.directory, step, tree, meta=meta)
        self._gc()
        self.write_s.append(time.perf_counter() - t0)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        entries = os.listdir(self.directory)
        steps = sorted(d for d in entries if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)
        # a killed writer can strand a .tmp dir; at most one write is ever
        # in flight (ours, already renamed), so any .tmp seen here is stale
        for d in entries:
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def restore_latest(self, target_tree: Pytree, shardings=None):
        self.wait()
        return restore_checkpoint(self.directory, target_tree, shardings=shardings)
