"""Dynamic property graph: host-side mutable store + device-friendly views.

The paper's graph model (§3.1): directed property graph, edge labels and
weights, update batches ``[(u, v, label, weight, +/-)]``.  A GDBMS keeps the
adjacency index on the host; the IFE compute consumes fixed-shape device
arrays.  Edge capacity is preallocated so update batches never change array
shapes, and deleted slots are marked invalid.

Device layout is COO (``src``, ``dst``, ``w``, ``valid``) for the engine's
scatter-reduce path; the CUDA ``ell_spmv`` kernel consumes the bucketed-ELL
view produced by :meth:`GraphSnapshot.to_ell`.

Numpy only.  Construction of :class:`DynamicGraph`, :meth:`GraphSnapshot.to_ell`
and :class:`EllIndex` is vectorized (a real-size graph holds tens of millions
of edges) and produces cell for cell what the one-edge-at-a-time loops of the
reference produce: ELL rows fill in ascending live-slot order.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import MutableMapping
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

# An update is (u, v, label, weight, +1|-1) as in the paper §3.1.
Update = tuple[int, int, int, float, int]

# A resolved op is (kind, slot, u, v, weight) where kind ∈ {"insert",
# "update", "delete"}: the slot-level effect of one accepted update
# ("update" = weight change in place; no-op deletions are filtered out).
ResolvedOp = tuple[str, int, int, int, float]

NO_LABEL = 0


def _ell_cells(dst: np.ndarray, valid: np.ndarray, num_vertices: int):
    """(live slots, their rows, their columns, in-degree) of the ELL fill.

    Row ``t`` receives its live in-edges in ascending slot order, so an
    edge's column is its rank among the live slots with the same ``dst``.
    """
    live = np.nonzero(valid)[0]
    rows = dst[live].astype(np.int64)
    indeg = np.bincount(rows, minlength=num_vertices)
    # stable: slot order within a row.  torch's CPU sort of int64 keys (a
    # parallel radix sort) takes about a third of numpy's stable argsort at
    # cit-Patents' 15 M edges, and every ELL engine build sorts twice
    keys, order = torch.sort(torch.from_numpy(rows), stable=True)
    start = np.cumsum(indeg) - indeg
    cols = np.empty(live.shape[0], np.int64)
    cols[order.numpy()] = np.arange(live.shape[0]) - start[keys.numpy()]
    return live, rows, cols, indeg


@dataclasses.dataclass
class GraphSnapshot:
    """Immutable fixed-shape device-friendly view of the graph."""

    num_vertices: int
    src: np.ndarray  # int32 [E_cap]
    dst: np.ndarray  # int32 [E_cap]
    weight: np.ndarray  # float32 [E_cap]
    label: np.ndarray  # int32 [E_cap]
    valid: np.ndarray  # bool [E_cap]
    out_degree: np.ndarray  # int32 [V]
    in_degree: np.ndarray  # int32 [V]

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.valid.sum())

    def degrees_total(self) -> np.ndarray:
        return self.out_degree + self.in_degree

    def to_ell(
        self, pad_to_multiple: int = 8, min_width: int = 0
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """In-adjacency in ELL layout (for the ``ell_spmv`` kernel).

        Returns ``(nbr, w, D)`` with ``nbr``/``w`` of shape ``[V, D]`` where
        ``D`` is the max in-degree rounded up; padded slots have ``nbr == V``
        (a sentinel row; callers pad the state vector with the reduce
        identity at index V).  ``min_width`` keeps ``D`` fixed across update
        batches.  (The reference's ``row_multiple`` row padding serves the
        Pallas kernel's block contract; the CUDA kernel masks its ragged
        edge and needs none.)
        """
        v = self.num_vertices
        live, rows, cols, indeg = _ell_cells(self.dst, self.valid, v)
        d = max(int(indeg.max()) if v else 0, min_width)
        d = max(pad_to_multiple, ((d + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple)
        nbr = np.full((v, d), v, dtype=np.int32)
        w = np.zeros((v, d), dtype=np.float32)
        nbr[rows, cols] = self.src[live]
        w[rows, cols] = self.weight[live]
        return nbr, w, d


class SlotIndex(MutableMapping):
    """``(u, v, label) -> slot`` of the live edges: the reference's
    ``DynamicGraph._slot`` dict, cheap to build from the edge arrays.

    The edges it is built from stay as arrays, sorted by ``u * V + v`` on
    the first lookup (a stable radix sort: a few seconds at 15 M edges,
    where a dict of 15 M tuples took 17-21 s); later inserts and deletes go
    to a dict of edits (``-1``: deleted), read first; a batch
    (``DynamicGraph.apply_batch_resolved``) searches the sorted arrays for
    all its keys at once (:meth:`base_slots`).  Once the edits pass
    ``1 / FOLD_FRACTION`` of the sorted entries (and ``FOLD_MIN``), they
    are folded in: the entries they replace are dropped and the live ones
    merged into new sorted arrays (at a batch's end), so the dict stays
    small on a long stream.  A key repeated in the arrays maps to its last
    occurrence, as a dict built from them would.  Equality with any mapping
    compares the items, so the index equals the reference's dict when it
    holds the same keys and slots.
    """

    FOLD_FRACTION = 16
    FOLD_MIN = 4096

    def __init__(self, num_vertices: int, u, v, label, slots) -> None:
        self._v = int(num_vertices)
        # copies: the graph's own arrays change under later batches
        self._cols = tuple(np.array(x, dtype=np.int64) for x in (u, v, label, slots))
        self._sorted: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self._edits: dict[tuple[int, int, int], int] = {}

    def copy(self) -> "SlotIndex":
        """An independent index: the sorted arrays built once here and
        shared (never written), the edits copied."""
        self._base()
        out = SlotIndex.__new__(SlotIndex)
        out._v, out._cols, out._sorted, out._edits = self._v, None, self._sorted, dict(self._edits)
        return out

    def _base(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pair keys ascending, labels, slots); equal pairs in array order."""
        if self._sorted is None:
            u, v, lbl, slots = self._cols
            keys, order = torch.sort(torch.from_numpy(u * self._v + v), stable=True)
            order = order.numpy()
            self._sorted, self._cols = (keys.numpy(), lbl[order], slots[order]), None
        return self._sorted

    def _lookup(self, key) -> int:
        """The key's slot, or -1."""
        i = self._edits.get(key)
        return int(self.base_slots(np.array([key], np.int64))[0]) if i is None else i

    def _matches(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(row of ``keys`` [n, 3], position in the sorted arrays) of every
        sorted entry equal to a key, a key's entries in ascending order."""
        keys_s, labels, _ = self._base()
        u, v, lbl = (keys[:, j] for j in range(3))
        pair = u * self._v + v
        order = np.argsort(pair)  # ascending queries keep the searches' reads near each other
        lo, hi = np.empty_like(pair), np.empty_like(pair)
        lo[order], hi[order] = keys_s.searchsorted(pair[order], "left"), keys_s.searchsorted(pair[order], "right")
        count = np.where((v >= 0) & (v < self._v), hi - lo, 0)  # else u * V + v names another pair
        at = np.repeat(lo - np.cumsum(count) + count, count) + np.arange(int(count.sum()))
        who = np.repeat(np.arange(keys.shape[0]), count)
        hit = labels[at] == lbl[who]
        return who[hit], at[hit]

    def base_slots(self, keys: np.ndarray) -> np.ndarray:
        """Each ``[n, 3]`` int64 key's slot in the sorted arrays alone (the
        edits not read), ``-1`` where absent: one vectorised search for a
        batch."""
        slots = self._base()[2]
        last = np.full(keys.shape[0], -1, np.int64)
        who, at = self._matches(keys)
        np.maximum.at(last, who, at)  # the last occurrence wins
        return np.where(last >= 0, slots[np.maximum(last, 0)] if slots.size else -1, -1)

    def maybe_fold(self) -> None:
        """Fold the edits in once they pass the threshold."""
        if len(self._edits) > max(self.FOLD_MIN, self._base()[0].shape[0] // self.FOLD_FRACTION):
            self._fold()

    def _fold(self) -> None:
        """Merge the edits into new sorted arrays.  Every base entry of an
        edited key goes (a repeat included); the live edits are inserted at
        their pair; keys whose v lies outside [0, V) stay edits."""
        keys, labels, slots = self._base()
        n = len(self._edits)
        ek = np.fromiter(itertools.chain.from_iterable(self._edits), np.int64, 3 * n).reshape(-1, 3)
        es = np.fromiter(self._edits.values(), np.int64, n)
        keep = np.ones(keys.shape[0], bool)
        keep[self._matches(ek)[1]] = False
        inside = (ek[:, 1] >= 0) & (ek[:, 1] < self._v)
        e = np.stack([ek[:, 0] * self._v + ek[:, 1], ek[:, 2], es], axis=1)[inside]
        add = e[e[:, 2] >= 0]
        add = add[np.argsort(add[:, 0], kind="stable")]
        kept = keys[keep]
        pos = kept.searchsorted(add[:, 0], "right")
        self._sorted = (np.insert(kept, pos, add[:, 0]), np.insert(labels[keep], pos, add[:, 1]),
                        np.insert(slots[keep], pos, add[:, 2]))
        self._edits = {k: i for k, i in self._edits.items() if not 0 <= k[1] < self._v}

    def __contains__(self, key) -> bool:
        return self._lookup(key) >= 0

    def __getitem__(self, key) -> int:
        i = self._lookup(key)
        if i < 0:
            raise KeyError(key)
        return i

    def __setitem__(self, key, slot: int) -> None:
        self._edits[key] = int(slot)
        self.maybe_fold()

    def __delitem__(self, key) -> None:
        if self._lookup(key) < 0:
            raise KeyError(key)
        self._edits[key] = -1
        self.maybe_fold()

    def __iter__(self) -> Iterator[tuple[int, int, int]]:
        keys, labels, _ = self._base()
        seen = set(self._edits)
        for pair, lbl in zip(keys.tolist(), labels.tolist()):
            key = (pair // self._v, pair % self._v, lbl)
            if key not in seen:
                seen.add(key)
                yield key
        yield from (k for k, i in self._edits.items() if i >= 0)

    def __len__(self) -> int:
        return sum(1 for _ in self)


class DynamicGraph:
    """Host-side dynamic graph with slot-recycling edge storage."""

    def __init__(
        self,
        num_vertices: int,
        edges: Sequence[tuple] | np.ndarray,
        *,
        capacity: int | None = None,
        weighted: bool = True,
    ) -> None:
        u, v, w, lbl = _edge_columns(edges, weighted)
        n = int(u.shape[0])
        cap = capacity if capacity is not None else max(16, int(n * 1.5))
        if cap < n:
            raise ValueError("capacity below initial edge count")
        self.num_vertices = int(num_vertices)
        self.weighted = weighted
        self.src = np.full(cap, 0, dtype=np.int32)
        self.dst = np.full(cap, 0, dtype=np.int32)
        self.weight = np.zeros(cap, dtype=np.float32)
        self.label = np.zeros(cap, dtype=np.int32)
        self.valid = np.zeros(cap, dtype=bool)
        self.src[:n], self.dst[:n] = u, v
        self.weight[:n], self.label[:n] = w, lbl
        self.valid[:n] = True
        self.out_degree = np.bincount(u, minlength=self.num_vertices).astype(np.int32)
        self.in_degree = np.bincount(v, minlength=self.num_vertices).astype(np.int32)
        if self.out_degree.shape[0] != self.num_vertices or (
            self.in_degree.shape[0] != self.num_vertices
        ):
            raise IndexError("edge endpoint outside [0, num_vertices)")
        # a repeated (u, v, label) keeps its LAST slot, as sequential inserts would
        self._slot = SlotIndex(self.num_vertices, u, v, lbl, np.arange(n))
        self._free: list[int] = list(range(cap - 1, n - 1, -1))
        self.version = 0  # G_k

    # ------------------------------------------------------------ durability
    def state_dict(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) capturing the full mutable state.

        The free list is saved as an *ordered* array: slot recycling order
        decides which slot a replayed insert lands in.
        """
        arrays = {
            "src": self.src.copy(),
            "dst": self.dst.copy(),
            "weight": self.weight.copy(),
            "label": self.label.copy(),
            "valid": self.valid.copy(),
            "out_degree": self.out_degree.copy(),
            "in_degree": self.in_degree.copy(),
            "free": np.asarray(self._free, dtype=np.int64),
        }
        meta = {
            "num_vertices": self.num_vertices,
            "weighted": self.weighted,
            "version": self.version,
        }
        return arrays, meta

    @classmethod
    def from_state(cls, meta: dict, arrays: dict) -> "DynamicGraph":
        return cls.assemble(int(meta["num_vertices"]), arrays,
                            np.asarray(arrays["free"], dtype=np.int64).tolist(),
                            weighted=bool(meta["weighted"]), version=int(meta["version"]))

    _ARRAYS = (("src", np.int32), ("dst", np.int32), ("weight", np.float32), ("label", np.int32),
               ("valid", bool), ("out_degree", np.int32), ("in_degree", np.int32))

    @classmethod
    def assemble(cls, num_vertices: int, arrays: dict, free: list[int], *, weighted: bool = True,
                 version: int = 0) -> "DynamicGraph":
        """A graph from its edge-slot arrays (copied, in the graph's dtypes)
        and its ordered free list, the slot index taken from the live slots;
        no free list of the whole capacity is built first."""
        g = cls.__new__(cls)
        g.num_vertices = int(num_vertices)
        g.weighted = bool(weighted)
        for name, dtype in cls._ARRAYS:
            setattr(g, name, np.array(arrays[name], dtype=dtype))
        live = np.nonzero(g.valid)[0]
        g._slot = SlotIndex(g.num_vertices, g.src[live], g.dst[live], g.label[live], live)
        g._free = free
        g.version = int(version)
        return g

    # ------------------------------------------------------------------ api
    @property
    def num_edges(self) -> int:
        return int(self.valid.sum())

    @property
    def capacity(self) -> int:
        return int(self.src.shape[0])

    def snapshot(self) -> GraphSnapshot:
        return GraphSnapshot(
            num_vertices=self.num_vertices,
            src=self.src.copy(),
            dst=self.dst.copy(),
            weight=self.weight.copy(),
            label=self.label.copy(),
            valid=self.valid.copy(),
            out_degree=self.out_degree.copy(),
            in_degree=self.in_degree.copy(),
        )

    def apply_batch(self, updates: Iterable[Update]) -> list[tuple[int, int]]:
        """Apply one δE batch; returns the touched (src, dst) endpoints.

        Insertions of an existing (u, v, label) update the weight in place.
        Endpoints — not slots — are returned because a later insert in the
        same batch may recycle a freed slot.
        """
        return [(u, v) for (_kind, _slot, u, v, _w) in self.apply_batch_resolved(updates)]

    def apply_batch_resolved(self, updates: Iterable[Update]) -> list[ResolvedOp]:
        """Apply one δE batch, returning the slot-level effect of every
        accepted update (the device mirror the batched engine step scatters).
        """
        updates = list(updates)
        index = self._slot
        # every key's slot in the sorted arrays at once; the edits of this
        # batch are read first, and no fold runs until its end
        keys = np.fromiter(itertools.chain.from_iterable(t[:3] for t in updates), np.int64, 3 * len(updates))
        base = index.base_slots(keys.reshape(-1, 3)).tolist()
        edits = index._edits
        ops: list[ResolvedOp] = []
        for (u, v, lbl, w, sign), b in zip(updates, base):
            u, v, lbl = int(u), int(v), int(lbl)
            key = (u, v, lbl)
            i = edits.get(key, b)
            if sign > 0:
                if i >= 0:
                    self.weight[i] = float(w)
                    ops.append(("update", i, u, v, float(w)))
                else:
                    if not self._free:
                        index.maybe_fold()
                        raise MemoryError("edge capacity exhausted")
                    i = self._free.pop()
                    self.src[i], self.dst[i] = u, v
                    self.weight[i], self.label[i] = float(w), lbl
                    self.valid[i] = True
                    edits[key] = i
                    self.out_degree[u] += 1
                    self.in_degree[v] += 1
                    ops.append(("insert", i, u, v, float(w)))
            else:
                if i < 0:
                    continue  # deleting a non-existent edge is a no-op
                edits[key] = -1
                self.valid[i] = False
                self._free.append(i)
                self.out_degree[u] -= 1
                self.in_degree[v] -= 1
                ops.append(("delete", i, u, v, float(w)))
        index.maybe_fold()
        self.version += 1
        return ops

    def degree_percentile(self, pct: float) -> float:
        """Degree threshold at the given percentile (paper: τ_max = 80th)."""
        deg = self.degrees_total()
        return float(np.percentile(deg[deg > 0], pct)) if (deg > 0).any() else 0.0

    def degrees_total(self) -> np.ndarray:
        return self.out_degree + self.in_degree


def _edge_columns(
    edges: Sequence[tuple] | np.ndarray, weighted: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(u, v, weight, label) columns of an edge list.

    ``edges`` is a sequence of ``(u, v[, w[, label]])`` tuples or an
    ``[n, 2..4]`` array with those columns.  Weights are 1.0 when the graph
    is unweighted or the weight column is absent; labels default to
    :data:`NO_LABEL`.
    """
    if isinstance(edges, np.ndarray):
        n = edges.shape[0]
        ncol = edges.shape[1] if edges.ndim == 2 else 0
        u = edges[:, 0].astype(np.int64) if n else np.zeros(0, np.int64)
        v = edges[:, 1].astype(np.int64) if n else np.zeros(0, np.int64)
        w = (
            edges[:, 2].astype(np.float64)
            if (weighted and ncol > 2)
            else np.ones(n, np.float64)
        )
        lbl = edges[:, 3].astype(np.int64) if ncol > 3 else np.full(n, NO_LABEL, np.int64)
        return u, v, w, lbl
    edges = list(edges)
    u = np.asarray([int(e[0]) for e in edges], np.int64)
    v = np.asarray([int(e[1]) for e in edges], np.int64)
    w = np.asarray(
        [float(e[2]) if (weighted and len(e) > 2) else 1.0 for e in edges], np.float64
    )
    lbl = np.asarray([int(e[3]) if len(e) > 3 else NO_LABEL for e in edges], np.int64)
    return u, v, w, lbl


@dataclasses.dataclass
class EllWrite:
    """One ELL cell assignment: ``nbr[row, col] = nbr_val; w[row, col] = w_val``."""

    row: int
    col: int
    nbr_val: int
    w_val: float


class EllOverflow(Exception):
    """A row ran out of ELL columns — the caller must rebuild at a wider D."""


class EllIndex:
    """Host mirror of the device ELL buffers (``GraphSnapshot.to_ell``).

    Tracks the (row = dst, col) cell of every live edge slot plus per-row free
    columns, so a δE batch becomes O(B) scatter writes on the device instead
    of an O(V·D) host rebuild + transfer.  A freshly built index agrees cell
    for cell with ``to_ell`` output.  ``row_of``/``col_of`` are indexed by
    edge slot; ``-1`` marks a slot without a live cell.
    """

    def __init__(self, snap: GraphSnapshot, width: int) -> None:
        self.v = snap.num_vertices
        self.width = int(width)
        live, rows, cols, indeg = _ell_cells(snap.dst, snap.valid, self.v)
        over = cols >= self.width
        if over.any():
            # the first slot (in fill order) that finds its row full
            t = int(rows[np.argmax(over)])
            raise EllOverflow(f"in-degree of vertex {t} exceeds width {self.width}")
        self.row_of = np.full(snap.capacity, -1, np.int64)
        self.col_of = np.full(snap.capacity, -1, np.int64)
        self.row_of[live], self.col_of[live] = rows, cols
        self.fill = indeg.astype(np.int64)
        self.free: dict[int, list[int]] = {}

    def _alloc(self, row: int) -> int:
        cols = self.free.get(row)
        if cols:
            return cols.pop()
        if self.fill[row] >= self.width:
            raise EllOverflow(f"in-degree of vertex {row} exceeds width {self.width}")
        col = int(self.fill[row])
        self.fill[row] += 1
        return col

    def writes_for(self, ops: Sequence[ResolvedOp]) -> list[EllWrite]:
        """Translate resolved slot ops into coalesced ELL cell writes.

        Raises :class:`EllOverflow` when an insert exceeds the fixed width;
        the index is then stale and must be rebuilt from the (already
        updated) host graph at a larger width.
        """
        writes: dict[tuple[int, int], EllWrite] = {}
        for (kind, slot, u, v, w) in ops:
            if kind == "delete":
                row, col = int(self.row_of[slot]), int(self.col_of[slot])
                self.row_of[slot] = self.col_of[slot] = -1
                self.free.setdefault(row, []).append(col)
                writes[(row, col)] = EllWrite(row, col, self.v, 0.0)
            elif kind == "insert":
                col = self._alloc(v)
                self.row_of[slot], self.col_of[slot] = v, col
                writes[(v, col)] = EllWrite(v, col, u, float(w))
            else:  # weight update in place
                row, col = int(self.row_of[slot]), int(self.col_of[slot])
                writes[(row, col)] = EllWrite(row, col, u, float(w))
        return list(writes.values())


@dataclasses.dataclass
class ShardWrite:
    """One sharded edge-cell assignment at linear index ``lin``
    (= shard · shard_capacity + position within the shard's cell range)."""

    lin: int
    src: int
    dst: int
    weight: float
    valid: bool


class ShardOverflow(Exception):
    """A destination shard ran out of edge cells — rebuild at a larger
    per-shard capacity (the index is stale once this is raised)."""


def shard_capacity(capacity: int, num_shards: int, fullest: int = 0, min_capacity: int = 0) -> int:
    """Edge cells a shard of :class:`ShardIndex`'s layout has: the fullest
    shard's live edges, the host ``capacity`` spread evenly over
    ``num_shards``, ``min_capacity`` and 8, the largest rounded up to 8."""
    cap = max(int(fullest), -(-int(capacity) // num_shards), int(min_capacity), 8)
    return -(-cap // 8) * 8


class ShardIndex:
    """Host mirror of the vertex-sharded edge layout (the mesh's data axis).

    Shard ``k`` of ``n`` owns the vertex block ``[k·V/n, (k+1)·V/n)`` and
    every edge whose DESTINATION falls in it, laid out in the cell range
    ``[k·C, (k+1)·C)`` (``C`` = ``shard_capacity``): a fresh index fills
    each shard's cells in ascending slot order.  A δE chunk becomes one
    scatter into the owning shards.  Deleted cells keep their endpoints (the
    VDC J store's identity-overwrite rule needs a deleted edge's old
    destination) and return to their shard's free list.

    ``cell_of`` is indexed by edge slot (``-1``: no live cell), where the
    reference keeps a dict; the build is one stable sort by shard.
    """

    def __init__(self, snap: GraphSnapshot, num_shards: int, *, min_capacity: int = 0) -> None:
        v, n = snap.num_vertices, int(num_shards)
        if v % n:
            raise ValueError(f"num_vertices {v} not divisible by {n} shards")
        self.num_shards = n
        self.vertices_per_shard = v // n
        live = np.nonzero(snap.valid)[0]
        shard = snap.dst[live].astype(np.int64) // self.vertices_per_shard
        counts = np.bincount(shard, minlength=n)
        self.shard_capacity = shard_capacity(snap.capacity, n, int(counts.max(initial=0)), min_capacity)
        order = np.argsort(shard, kind="stable")  # stable: slot order within a shard
        start = np.cumsum(counts) - counts
        pos = np.empty(live.shape[0], np.int64)
        pos[order] = np.arange(live.shape[0]) - start[shard[order]]
        self.cell_of = np.full(snap.capacity, -1, np.int64)  # edge slot → linear cell
        self.cell_of[live] = shard * self.shard_capacity + pos
        self.dead: dict[int, tuple[int, int]] = {}  # freed cell → endpoints
        self.fill = counts.astype(np.int64)
        self.free: dict[int, list[int]] = {}

    @property
    def size(self) -> int:
        """Cells over all shards."""
        return self.num_shards * self.shard_capacity

    def cells(self) -> tuple[np.ndarray, np.ndarray]:
        """(live edge slots, their linear cells)."""
        slots = np.nonzero(self.cell_of >= 0)[0]
        return slots, self.cell_of[slots]

    def _alloc(self, shard: int) -> int:
        cells = self.free.get(shard)
        if cells:
            return cells.pop()
        if self.fill[shard] >= self.shard_capacity:
            raise ShardOverflow(f"shard {shard} edge cells exhausted at {self.shard_capacity}")
        lin = shard * self.shard_capacity + int(self.fill[shard])
        self.fill[shard] += 1
        return lin

    def writes_for(self, ops: Sequence[ResolvedOp]) -> list[ShardWrite]:
        """Translate resolved slot ops into coalesced sharded-cell writes.

        Raises :class:`ShardOverflow` when an insert exceeds a shard's fixed
        capacity; the index is then stale and must be rebuilt from the
        (already updated) host graph.
        """
        writes: dict[int, ShardWrite] = {}
        for (kind, slot, u, v, w) in ops:
            if kind == "delete":
                lin = int(self.cell_of[slot])
                self.cell_of[slot] = -1
                self.free.setdefault(lin // self.shard_capacity, []).append(lin)
                self.dead[lin] = (u, v)
                writes[lin] = ShardWrite(lin, u, v, float(w), False)
            elif kind == "insert":
                lin = self._alloc(v // self.vertices_per_shard)
                self.cell_of[slot] = lin
                self.dead.pop(lin, None)
                writes[lin] = ShardWrite(lin, u, v, float(w), True)
            else:  # weight update in place
                lin = int(self.cell_of[slot])
                writes[lin] = ShardWrite(lin, u, v, float(w), True)
        return list(writes.values())

    def edge_arrays(self, snap: GraphSnapshot) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Sharded-layout COO arrays ``[n · shard_capacity]`` from a snapshot.

        Freed cells keep their last endpoints, as the scatter path
        (:meth:`writes_for`) leaves them; never-used cells hold edge 0 → 0,
        invalid.
        """
        src = np.zeros(self.size, np.int32)
        dst = np.zeros(self.size, np.int32)
        w = np.zeros(self.size, np.float32)
        valid = np.zeros(self.size, bool)
        slots, lin = self.cells()
        src[lin], dst[lin] = snap.src[slots], snap.dst[slots]
        w[lin], valid[lin] = snap.weight[slots], snap.valid[slots]
        if self.dead:
            dead = np.fromiter(self.dead.keys(), np.int64, len(self.dead))
            ends = np.array(list(self.dead.values()), np.int32).reshape(-1, 2)
            src[dead], dst[dead] = ends[:, 0], ends[:, 1]
        return src, dst, w, valid


def product_graph(
    g: "DynamicGraph | GraphSnapshot",
    nfa_delta: dict[int, list[tuple[int, int]]],
    num_states: int,
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """RPQ product construction: vertex (v, q) with id ``v * num_states + q``.

    ``nfa_delta`` maps edge label → list of (q, q') NFA transitions.  Returns
    ``(num_product_vertices, src, dst, w, parent_edge_slot)`` COO arrays (one
    product edge per (graph edge, matching transition)).
    """
    live = np.nonzero(g.valid)[0]
    srcs, dsts, slots = [], [], []
    for e in live:
        for (q, q2) in nfa_delta.get(int(g.label[e]), ()):
            srcs.append(int(g.src[e]) * num_states + q)
            dsts.append(int(g.dst[e]) * num_states + q2)
            slots.append(int(e))
    n = g.num_vertices * num_states
    src = np.asarray(srcs, dtype=np.int32)
    dst = np.asarray(dsts, dtype=np.int32)
    w = np.ones(len(srcs), dtype=np.float32)
    return n, src, dst, w, np.asarray(slots, dtype=np.int32)
