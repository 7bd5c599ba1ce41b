"""Differential IFE engine — the paper's maintenance procedure, dense, in PyTorch.

The port of ``repro/core/engine.py`` for one device: JOD mode
(Join-On-Demand, §4: no per-edge join store, messages are recomputed from
in-neighbour states every iteration) or VDC mode (the Join operator's
differences are stored per edge in the ``[Q, E_cap, S_J]`` J store and the
aggregator reads them; ``join_mat`` turns the store off per query slot),
partial dropping (§5: Det-Drop or Prob-Drop, Random or Degree selection) or
none, and one of three backends: ``coo`` (scatter-reduce), ``ell`` (the CUDA
``ell_spmv`` kernel as the aggregator, JOD only) or ``fused`` (the CUDA
``fused_sweep`` kernel: the whole per-vertex iteration in one launch; in VDC
it takes the aggregated candidate).  The J store's lookups go through the
CUDA ``diff_lookup`` kernel.  The leading Q axis is a pool of query slots
(``state.active``; :meth:`DiffIFE.register_slots`, ``deregister_slot``,
geometric regrow) that the session layer (``core/session.py``) drives.

Timestamps are eager-merged (§4.2) so each (query, vertex) holds a 1-D sorted
list of (iteration, state) change points; negative multiplicities are implied
(DESIGN.md §2).

Maintenance is a bounded forward sweep over IFE iterations.  Per iteration i:

    cur        exact D_{i-1} for every vertex
    sched_i    vertices whose aggregator must rerun: frontier (δD direct
               rule) ∪ dirty (δE direct rule + upper-bound rule: touched
               endpoints are rerun at every live iteration — spurious reruns
               are safe, Thm 4.1 corollary)
    changed_i  sched_i whose recomputed value differs from the pre-update
               trajectory → out-neighbours enter frontier_{i+1}

The sweep ends when the frontier is empty and i exceeds the stored horizon
(max change-point iteration, or the highest dropped iteration if later),
bounded by ``max_iters``.  The reference runs it as one ``lax.while_loop``;
here it is a host loop that reads the loop scalars (``live``, ``horizon``,
``drop.max_iter``) from the device in one sync per iteration.

Every sweep function below is pure in the engine state: a sweep builds new
store tensors and leaves its input state as it was, which is how the
pre-update store stays frozen for δ detection.  The one in-place store is
the J store, which a sweep clones once and then updates row by row (see
:func:`_sweep`).  :func:`batched_step` updates the graph arrays in
place, where the reference donates them.  Between sweeps, the slot-pool
edits of :class:`DiffIFE` (register, deregister, :func:`shed_slot`) write
the affected slot's rows of the engine's own state in place, where the
reference builds new arrays (``.at[slot].set``).

**Vertex-sharded sweep** (DESIGN.md §8): with a :class:`~repro_torch.launch.
mesh.DataMesh` of N shards, every per-vertex carry — diff-store rows,
DroppedVT rows, ``init``/``cur``/``repair_counts``, the frontier and dirty
masks, the in-degrees and ELL rows, and VDC's J rows over the edge cells —
splits by destination vertex: shard k owns ``[k·V/N, (k+1)·V/N)`` and every
edge whose destination lies there (the :class:`ShardIndex` cell layout).
The Bloom bits, the selection rows, ``active``/``join_mat``, the out-degrees
and the loop scalars are replicated.  Where the reference runs the sweep body
under ``shard_map``, the port's host loop runs every shard's body in turn
and then the collectives of ``launch/mesh.py``: the exact front is gathered
once an iteration, the shards' dropped and evicted masks are gathered and
inserted into the Bloom bits after every shard has probed them (twice a
device, as unsharded), ``det_overflow`` is summed, ``max_iter`` maxed, the
changed mask gathered for the frontier push (one push a device), and the
loop scalars reduced on the first shard's device, read in the one host
sync an iteration.  The unsharded sweep and :func:`batched_step` are the
one-shard case of the same functions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bloom as bloom_lib
from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.core.graph import (
    DynamicGraph,
    EllIndex,
    EllOverflow,
    GraphSnapshot,
    ShardIndex,
    ShardOverflow,
)
from repro_torch.core.semiring import Semiring, reduce_pair
from repro_torch.kernels.diff_lookup import diff_lookup
from repro_torch.kernels.ell_spmv import ell_spmv, transpose_states
from repro_torch.kernels.fused_sweep import fused_sweep
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor

def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------------------------- graph arrays
class GraphArrays(NamedTuple):
    """Fixed-shape device view of the graph (COO + degrees).

    With ``backend="ell"`` or ``"fused"`` the bucketed in-adjacency
    (``nbr``/``ell_w``, shape [V, D]) rides along for the kernels; the COO
    arrays stay — the frontier push and the δE dirty propagation are
    edge-indexed.
    """

    src: Tensor  # int32 [E]
    dst: Tensor  # int32 [E]
    weight: Tensor  # f32 [E]
    valid: Tensor  # bool [E]
    out_degree: Tensor  # int32 [V]
    in_degree: Tensor  # int32 [V]
    nbr: Tensor | None = None  # int32 [V, D] in-neighbour ids (== V padding)
    ell_w: Tensor | None = None  # f32 [V, D] edge weights

    @property
    def num_vertices(self) -> int:
        return self.out_degree.shape[0]

    @property
    def ell_width(self) -> int:
        return 0 if self.nbr is None else int(self.nbr.shape[1])

    @classmethod
    def from_snapshot(
        cls,
        s: GraphSnapshot,
        *,
        backend: str = "coo",
        ell_min_width: int = 0,
        device=None,
    ) -> "GraphArrays":
        device = resolve_device(device)

        def put(x: np.ndarray) -> Tensor:
            return torch.from_numpy(x).to(device)

        nbr = ell_w = None
        if backend in ("ell", "fused"):
            nbr_np, w_np, _ = s.to_ell(min_width=ell_min_width)
            nbr, ell_w = put(nbr_np), put(w_np)
        return cls(
            src=put(s.src),
            dst=put(s.dst),
            weight=put(s.weight),
            valid=put(s.valid),
            out_degree=put(s.out_degree),
            in_degree=put(s.in_degree),
            nbr=nbr,
            ell_w=ell_w,
        )


# --------------------------------------------------------------------------- config / state
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_queries: int
    num_vertices: int
    max_iters: int
    semiring: Semiring
    mode: str = "jod"  # "vdc" | "jod"
    store_capacity: int = 16  # S: change points per (q, v)
    jstore_capacity: int = 8  # S_J: per-edge change points (vdc only)
    drop: dr.DropConfig = dataclasses.field(default_factory=dr.DropConfig)
    # PageRank: edge weight is alpha / outdeg(src), recomputed from degrees so
    # deletions retune every sibling message (dirty mask covers them).
    weight_from_degree: bool = False
    alpha: float = 0.85
    # Aggregator backend: "coo" = masked scatter-reduce over the edge list;
    # "ell" = the CUDA bucketed-ELL SpMV kernel (JOD only — the kernel *is*
    # the fused Join+Min); "fused" = the maintenance kernel (K2): expand,
    # DroppedVT probe, δ detection and store upsert/remove in one launch.
    backend: str = "coo"

    def __post_init__(self):
        if self.mode not in ("vdc", "jod"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.backend not in ("coo", "ell", "fused"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "ell" and self.mode != "jod":
            raise ValueError("backend='ell' realizes JOD; VDC reads the J store")


class EngineState(NamedTuple):
    dstore: ds.DiffStore  # [Q, V, S] — the Iterate operator's difference store
    jstore: ds.DiffStore | None  # [Q, E, S_J] — the Join operator's store (vdc)
    drop: dr.DropState
    init: Tensor  # f32 [Q, V] — D_0 (implicit iteration-0 diffs)
    cur: Tensor  # f32 [Q, V] — exact values at the last swept iteration
    repair_counts: Tensor  # int32 [Q, V] — dropped-diff recomputations (Fig 6b)
    active: Tensor  # bool [Q] — live query slots
    join_mat: Tensor | None = None  # bool [Q] — per-slot Join materialization (vdc):
    # False = that slot's join differences are dropped completely and its
    # messages recompute on demand (JOD) inside the VDC engine


# Per-iteration probe depth: sweep iterations beyond this fold into the last bin.
ITER_TRACE = 32


class MaintainStats(NamedTuple):
    iters_run: Tensor  # int32
    scheduled: Tensor  # int32 — Σ|sched_i| (algorithmic work, vertex reruns)
    changed: Tensor  # int32 — Σ|changed_i| (δD differences produced)
    repairs: Tensor  # int32 — Σ|repair_i \ sched_i| (dropped diffs recomputed)
    written: Tensor  # int32 — change points upserted
    removed: Tensor  # int32 — change points deleted (cancelled +/- pairs)
    dropped: Tensor  # int32 — change points dropped instead of stored
    jwritten: Tensor  # int32 — J change points upserted (vdc)
    det_overflow: Tensor  # int32 — dropped VT records lost to Det-Drop store
    sched_sizes: Tensor  # int32 [ITER_TRACE] — |sched_i| per iteration
    frontier_sizes: Tensor  # int32 [ITER_TRACE] — |frontier_{i+1}| per iteration

    SCALAR_FIELDS = (
        "iters_run", "scheduled", "changed", "repairs", "written",
        "removed", "dropped", "jwritten", "det_overflow",
    )
    VECTOR_FIELDS = ("sched_sizes", "frontier_sizes")


def zeros_stats(device=None) -> MaintainStats:
    z = torch.zeros((), dtype=torch.int32, device=device)
    t = torch.zeros((ITER_TRACE,), dtype=torch.int32, device=device)
    return MaintainStats(z, z, z, z, z, z, z, z, z, t, t)


def _stats_to_host(stats: MaintainStats) -> MaintainStats:
    """Numpy copies of the counters (what ``last_stats`` holds)."""
    return MaintainStats(*(x.cpu().numpy() for x in stats))


def _count(mask: Tensor) -> Tensor:
    """int32 popcount of a bool mask (torch sums bools to int64)."""
    return mask.sum(dtype=torch.int32)


# --------------------------------------------------------------------------- IFE primitives
def _alpha_over(cfg: EngineConfig, outd: Tensor) -> Tensor:
    """``float32(alpha) / outd`` as a float32 division: a Python float over a
    tensor would compute ``reciprocal(outd) * alpha``, which rounds
    differently from the reference."""
    return torch.full_like(outd, cfg.alpha) / outd


def effective_weight(cfg: EngineConfig, g: GraphArrays) -> Tensor:
    if cfg.weight_from_degree:
        outd = g.out_degree.index_select(0, g.src).clamp(min=1).to(torch.float32)
        return _alpha_over(cfg, outd)
    return g.weight


def edge_messages(cfg: EngineConfig, states: Tensor, g: GraphArrays) -> Tensor:
    """J from D: per-edge messages, identity on invalid slots. [Q, E]"""
    sr = cfg.semiring
    msgs = sr.msg(states.index_select(1, g.src), effective_weight(cfg, g)[None, :])
    return torch.where(g.valid[None, :], msgs, sr.identity)


def aggregate(
    cfg: EngineConfig,
    msgs: Tensor,
    cur: Tensor,
    g: GraphArrays,
    *,
    dst: Tensor | None = None,
    num_segments: int | None = None,
) -> Tensor:
    """D_i from J_i (+ carry of D_{i-1}): the Min/Sum operator. [Q, V]

    Empty segments read +inf under min and 0 under sum, as the reference's
    ``segment_min``/``segment_sum`` fill them.  The sum adds each segment
    in one fixed order (the edges sorted by destination, stably): a
    scatter-add's atomics on the card would add in another order on every
    run, so two runs of one stream (VDC's ``coo`` and ``fused``) would part.
    On the CPU the order is the scatter-add's own, edge by edge.

    The sharded sweep passes its cells' local destinations and the block's
    extent; a foreign or padding cell's destination is ``num_segments``, a
    spare segment that is dropped.
    """
    sr = cfg.semiring
    q = msgs.shape[0]
    if dst is None:
        dst, v, spare = g.dst, cfg.num_vertices, 0
    else:
        v, spare = num_segments, 1
    if sr.reduce == "min":
        agg = torch.full((q, v + spare), float("inf"), dtype=msgs.dtype, device=msgs.device)
        idx = dst.long()[None, :].expand(q, -1)
        agg.scatter_reduce_(1, idx, msgs, "amin", include_self=True)
    else:
        order = torch.sort(dst, stable=True).indices
        lengths = torch.bincount(dst, minlength=v + spare).expand(q, -1).contiguous()
        agg = torch.segment_reduce(msgs.index_select(1, order), "sum", lengths=lengths, axis=1,
                                   unsafe=True)
    if spare:
        agg = agg[:, :v]
    if sr.carry_prev:
        return reduce_pair(sr, agg, cur)
    return agg + torch.full_like(agg, sr.base)


def _ell_weights(cfg: EngineConfig, g: GraphArrays) -> Tensor:
    """ELL weight tile; degree-derived weights are re-gathered every step so
    a δE batch retunes every sibling message without rewriting [V, D] cells."""
    if cfg.weight_from_degree:
        one = torch.ones((1,), dtype=torch.int32, device=g.out_degree.device)
        # index V (padding sentinel) → 1; its state is the identity 0 anyway
        outd = torch.cat([g.out_degree.clamp(min=1), one])
        return _alpha_over(cfg, outd[g.nbr.long()].to(torch.float32))
    return g.ell_w


def _ell_operands(cfg: EngineConfig, cur: Tensor, g: GraphArrays, carry: Tensor | None = None) -> dict:
    """The expand's operands for the ELL and fused kernels: the states
    transposed, ``[V+1, Q]`` with the identity in the sentinel row V that
    padding cells point at (built in one pass, as the kernels read them),
    the weight tile and the carry.  ``cur`` is the full front the kernel
    gathers from; ``carry`` (default ``cur``) the shard's block matching
    ``g.nbr``'s rows."""
    sr = cfg.semiring
    loc = cur if carry is None else carry
    return dict(
        states=transpose_states(cur, sr.identity),
        transposed=True,
        nbr=g.nbr,
        w=_ell_weights(cfg, g),
        kcarry=loc if sr.carry_prev else torch.full_like(loc, sr.base),
    )


def ell_step(cfg: EngineConfig, cur: Tensor, g: GraphArrays, *, carry: Tensor | None = None) -> Tensor:
    """One exact IFE step through the ELL SpMV kernel (JOD fused); ``cur``
    and ``carry`` as for :func:`_ell_operands`."""
    ops = _ell_operands(cfg, cur, g, carry)
    sr = cfg.semiring
    return ell_spmv(
        ops["states"], ops["nbr"], ops["w"], ops["kcarry"],
        semiring=sr.kernel_name, hop_cap=sr.hop_cap, transposed=True,
    )


def ife_step(
    cfg: EngineConfig,
    cur: Tensor,
    g: GraphArrays,
    *,
    carry: Tensor | None = None,
    dst: Tensor | None = None,
    num_segments: int | None = None,
) -> Tensor:
    """One exact IFE step D_{i-1} → D_i (join recomputed — the JOD path).
    Under ``fused`` it is the ELL step (the scratch oracle reuses it).

    ``cur`` is the full ``[Q, V]`` front; the sharded sweep's ``carry``,
    ``dst`` and ``num_segments`` restrict the output to its block."""
    if cfg.backend in ("ell", "fused"):
        return ell_step(cfg, cur, g, carry=carry)
    return aggregate(cfg, edge_messages(cfg, cur, g), cur if carry is None else carry, g,
                     dst=dst, num_segments=num_segments)


def push_frontier(changed: Tensor, g: GraphArrays) -> Tensor:
    """Out-neighbour mask of changed vertices (δD direct rule).

    The reference takes a ``segment_max`` of the per-edge hits over ``dst``;
    an OR needs no reduction, so the (few) hit edges set their destination
    directly — a scatter-add over every ``[Q, E]`` cell costs far more on
    the card (see PERF.md).  The sweep pushes every shard of a device at
    once (:func:`_push`).
    """
    return _push_cells(changed, g.src, g.valid, g.dst, changed.shape[1])


def _push_cells(changed: Tensor, src: Tensor, valid: Tensor, dst: Tensor, width: int) -> Tensor:
    """``[Q, width]``: column ``dst[e]`` set where edge cell e is valid and
    its source changed (one ``nonzero``, a host sync)."""
    hit = changed.index_select(1, src) & valid[None, :]
    q_idx, e_idx = hit.nonzero(as_tuple=True)
    out = torch.zeros((changed.shape[0], width), dtype=torch.bool, device=changed.device)
    out[q_idx, dst[e_idx].long()] = True
    return out


def _local_dst(dst: Tensor, off: int, num_local: int) -> Tensor:
    """Global destination ids → the block ``[off, off + num_local)``;
    foreign ids collapse to ``num_local`` (a spare segment, dropped)."""
    dl = dst - off
    return torch.where((dl >= 0) & (dl < num_local), dl, num_local)


# --------------------------------------------------------------------------- maintenance
def make_state(
    cfg: EngineConfig,
    init: Tensor,
    num_edges: int,
    *,
    active=None,
    drop_rows: list[dr.DropConfig] | None = None,
    join_rows: list[bool] | None = None,
) -> EngineState:
    """Engine state for ``cfg.num_queries`` slots.

    ``active`` marks the live slots (default: all); ``drop_rows`` supplies
    each slot's selection parameters (default: ``cfg.drop`` broadcast);
    ``join_rows`` each slot's Join materialization flag (vdc only; default:
    every slot materializes).  VDC keeps the J store ``[Q, num_edges, S_J]``.
    """
    q, v = cfg.num_queries, cfg.num_vertices
    if tuple(init.shape) != (q, v):
        raise ValueError(f"init shape {tuple(init.shape)} != {(q, v)}")
    dev = init.device
    init = init.to(torch.float32)
    jstore = join_mat = None
    if cfg.mode == "vdc":
        jstore = ds.make((q, num_edges), cfg.jstore_capacity, device=dev)
        rows = [True] * q if join_rows is None else join_rows
        join_mat = torch.tensor(rows, dtype=torch.bool, device=dev)
        if tuple(join_mat.shape) != (q,):
            raise ValueError(f"join_rows has {join_mat.shape[0]} rows for {q} slots")
    return EngineState(
        dstore=ds.make((q, v), cfg.store_capacity, device=dev),
        jstore=jstore,
        drop=dr.make_state(cfg.drop, q, v, per_query=drop_rows, device=dev),
        init=init,
        cur=init,
        repair_counts=torch.zeros((q, v), dtype=torch.int32, device=dev),
        active=(
            torch.ones((q,), dtype=torch.bool, device=dev)
            if active is None
            else torch.as_tensor(np.asarray(active, bool)).to(dev)
        ),
        join_mat=join_mat,
    )


def stored_horizon(store: ds.DiffStore) -> Tensor:
    """Max change-point iteration present anywhere (the upper-bound frontier)."""
    return torch.where(store.iters < ds.IMAX, store.iters, -1).max()


class _Carry(NamedTuple):
    """One shard's loop carry (the whole vertex axis when unsharded)."""

    i: int  # the iteration this body computes (host loop counter)
    cur: Tensor  # exact D_{i-1} of the shard's block
    cur_old: Tensor  # pre-update trajectory value at i-1 (store-lookup based)
    stale_old: Tensor  # bool [Q,V]: old trajectory obscured by a dropped diff
    frontier: Tensor  # bool [Q,V]: δD direct-rule schedule for iteration i
    changed_prev: Tensor  # bool: changed at i-1, or (VDC) scheduled there (feeds the J
    # updates); VDC holds it over every vertex, gathered, as J's sources are global
    dstore: ds.DiffStore
    jstore: ds.DiffStore | None  # the sweep's own clone, updated in place (vdc)
    drop: dr.DropState
    repair_counts: Tensor  # int32 [Q,V]
    stats: MaintainStats  # the shard's partial counters
    owned: bool  # dstore (and the Det store) are the sweep's own buffers, not its input's


class _Shard(NamedTuple):
    """One shard's fixed inputs to a sweep (the whole graph when unsharded)."""

    state: EngineState  # its block of the input state; its store stays frozen (δ detection)
    g: GraphArrays  # its edge cells and ELL rows; out_degree spans every vertex
    dirty: Tensor  # bool [Q, V_local] — the schedule seed
    off: int  # global id of its first vertex
    dst: Tensor | None  # its cells' destinations in the block (None: unsharded, g.dst)
    degree: Tensor | None  # f32 [V_local] total degree (dropping on)
    dirty_pad: Tensor | None = None  # VDC: dirty with a padding column
    j0: Tensor | None = None  # VDC: the implicit J from D_0 over its cells


class _Step(NamedTuple):
    """One iteration's results, from the stitched path or the fused kernel."""

    dstore: ds.DiffStore
    drop: dr.DropState
    cur: Tensor
    old: Tensor
    stale: Tensor
    changed: Tensor
    repair: Tensor
    to_store: Tensor
    to_drop: Tensor
    vanish: Tensor
    # prob: the store's evictions at this iteration, inserted into the Bloom
    # bits with ``to_drop`` once every shard has probed them (_merge_drops)
    evicted: Tensor | None = None
    evicted_iter: Tensor | None = None


def _degree(g: GraphArrays, off: int = 0) -> Tensor:
    """Total degree per vertex (f32), the Degree selection's input: the
    block of the out-degrees at ``off`` plus the (shard's) in-degrees."""
    n = g.in_degree.shape[0]
    return (g.out_degree.narrow(0, off, n) + g.in_degree).to(torch.float32)


def _stitched_step(
    cfg: EngineConfig, sh: _Shard, sched: Tensor, c: _Carry, new: Tensor | None, cur_full: Tensor
) -> _Step:
    """One iteration as separate tensor passes around the aggregator
    (``new``: VDC's candidate from the J store; None runs the JOD step
    against the full front ``cur_full``)."""
    i = c.i
    q, v = c.cur.shape
    drop_on = cfg.drop.enabled()
    active = sh.state.active
    if new is None:
        new = ife_step(cfg, cur_full, sh.g, carry=c.cur, dst=sh.dst,
                       num_segments=None if sh.dst is None else v)

    # dropped change points at i must be recomputed to keep `cur` exact
    # (AccessDᵢᵛWithDrops, forward form); Prob-Drop may false-positive here
    # → spurious but safe recompute
    dropped_here = dr.dropped_at(c.drop, i, v, v_offset=sh.off) if drop_on else torch.zeros_like(sched)
    repair = dropped_here & active[:, None] & ~sched

    # pre-update trajectory at i (δ detection), from the frozen store; a
    # dropped old change point leaves old_i stale until the next stored old
    # point re-anchors it
    old_has, old_val = ds.value_at(sh.state.dstore, i)
    old_i = torch.where(old_has, old_val, c.cur_old)
    stale = (c.stale_old | dropped_here) & ~old_has
    changed = sched & ((new != old_i) | stale)

    # new trajectory change point at i?  (vs exact D_{i-1} = cur)
    want_point = sched & (new != c.cur)
    has_cur, cur_stored_val = ds.value_at(c.dstore, i)
    if drop_on:
        q_ids = torch.arange(q, dtype=torch.int32, device=sched.device)[:, None]
        v_ids = (sh.off + torch.arange(v, dtype=torch.int32, device=sched.device))[None, :]
        picked = dr.select_to_drop(c.drop.params, sh.degree[None, :], q_ids, v_ids, i)
        to_drop = want_point & picked
        to_store = want_point & ~to_drop
    else:
        to_drop = torch.zeros_like(want_point)
        to_store = want_point
    dstore, evicted, evicted_iter = ds.upsert(c.dstore, i, to_store, new)
    # one removal pass: a dropped point at i loses its stored twin, and a
    # vanished change point (+/- pair cancelled) is deleted
    vanish = sched & ~want_point & has_cur
    dstore = ds.remove_at(dstore, i, (to_drop & has_cur) | vanish)

    drop = c.drop
    if cfg.drop.mode == "det":
        drop = dr.register(drop, i, to_drop)
        drop = dr.register(drop, evicted_iter, evicted)
        # a dropped record is stale once the point is stored or vanished
        drop = dr.unregister(drop, i, to_store | vanish)
    if cfg.drop.mode != "prob":
        # only prob's Bloom inserts (in _merge_drops) read the evictions;
        # evicted_iter is a view of the input store, which it would keep alive
        evicted = evicted_iter = None

    cur_next = torch.where(sched | repair, new, torch.where(has_cur, cur_stored_val, c.cur))
    return _Step(dstore, drop, cur_next, old_i, stale, changed, repair, to_store, to_drop, vanish,
                 evicted, evicted_iter)


def _fused_step(
    cfg: EngineConfig, sh: _Shard, sched: Tensor, c: _Carry, new: Tensor | None, cur_full: Tensor
) -> _Step:
    """One iteration in one ``fused_sweep`` launch; Det rows come back from
    the kernel, Bloom inserts are left to :func:`_merge_drops` (the OR is
    idempotent, so the bits equal the stitched path's).  VDC passes its
    candidate as ``new=``; JOD runs the expand in the kernel, gathering from
    the full front.  The kernel hashes global vertex ids (``off``).

    The first iteration writes fresh stores (its working store is the
    frozen input state's); every later one updates the sweep's own D and
    Det stores in place, where the reference returns new arrays."""
    sr, mode = cfg.semiring, cfg.drop.mode
    kw: dict = _ell_operands(cfg, cur_full, sh.g, c.cur) if new is None else {"new": new}
    if cfg.drop.enabled():
        kw.update(degree=sh.degree, params=c.drop.params)
        if mode == "det":
            kw["det"] = c.drop.det
        else:
            kw.update(bloom_bits=c.drop.flt.bits, bloom_hashes=c.drop.flt.num_hashes)
    out = fused_sweep(
        c.i, sched, sh.state.active, c.cur, c.cur_old, c.stale_old, c.dstore, sh.state.dstore,
        semiring=sr.kernel_name, hop_cap=sr.hop_cap, drop_mode=mode, inplace=c.owned, off=sh.off,
        **kw,
    )
    drop = c.drop
    if mode == "det":
        drop = drop._replace(
            det=ds.DiffStore(out.det_iters, c.drop.det.vals, out.det_count),
            det_overflow=c.drop.det_overflow + out.det_overflow.sum(dtype=torch.int32),
            max_iter=torch.maximum(c.drop.max_iter, out.det_max_iter.max()),
        )
    return _Step(
        ds.DiffStore(out.d_iters, out.d_vals, out.d_count), drop, out.cur, out.old,
        out.stale, out.changed, out.repair, out.to_store, out.to_drop, out.vanish,
        *((out.evicted, out.evicted_iter) if mode == "prob" else ()),
    )


def _j_messages(jstore: ds.DiffStore, i: int, j0: Tensor) -> Tensor:
    """The J store's messages at iteration i: the latest stored change point
    ≤ i per (q, edge) through the ``diff_lookup`` kernel on the flattened
    ``[Q·E_cap, S_J]`` rows, else the implicit J from D_0. [Q, E]"""
    q, e, s = jstore.iters.shape
    val, _, found = diff_lookup(jstore.iters.view(q * e, s), jstore.vals.view(q * e, s), i)
    return torch.where(found.view(q, e), val.view(q, e), j0)


def _vdc_candidate(cfg: EngineConfig, sh: _Shard, c: _Carry, cur_full: Tensor) -> tuple[Tensor, Tensor]:
    """VDC's D_i candidate: maintain J at iteration i, then aggregate it.

    An edge's message is re-checked when its source was scheduled or changed
    at i-1 (``c.changed_prev``) or its destination was touched by δE
    (``dirty_pad`` has a padding column, so a destination ``== V`` stays
    legal).  A source scheduled at i-1 whose value rejoined the old
    trajectory reads as unchanged, yet the message stored for it may be one
    written earlier in the same sweep; gating on "changed" alone leaves that
    row stale under deletions (the reference's gate, ROADMAP Queue 3).  A
    message that differs from the stored one is upserted into
    the J store where the slot materializes its Join (``join_mat``) — in
    place, into the sweep's clone.  The aggregator then reads the stored
    messages for materializing slots and the on-demand ones otherwise.
    Deleted edges are deliberately not masked: their stored message must be
    overwritten with the identity.  Messages form against the full front
    ``cur_full`` (a shard's cells have sources anywhere).  Returns
    (candidate, rows written).
    """
    i, g = c.i, sh.g
    live_msgs = edge_messages(cfg, cur_full, g)
    jprev = _j_messages(c.jstore, i, sh.j0)
    jmat = sh.state.join_mat[:, None]
    dst = g.dst if sh.dst is None else sh.dst
    jdirty = c.changed_prev.index_select(1, g.src) | sh.dirty_pad.index_select(1, dst)
    jwrite = jdirty & (live_msgs != jprev) & jmat
    ds.upsert_rows_(c.jstore, i, jwrite, live_msgs)
    msgs = torch.where(jmat, _j_messages(c.jstore, i, sh.j0), live_msgs)
    num_local = None if sh.dst is None else c.cur.shape[1]
    return aggregate(cfg, msgs, c.cur, g, dst=sh.dst, num_segments=num_local), _count(jwrite)


def _shard_body(cfg: EngineConfig, sh: _Shard, c: _Carry, cur_full: Tensor) -> tuple[_Step, Tensor, Tensor]:
    """One shard's part of an IFE iteration, before the collectives:
    (step, sched, J rows written so far)."""
    # δE direct + upper-bound rules: dirty endpoints rerun at every live i
    sched = (c.frontier | sh.dirty) & sh.state.active[:, None]
    new, jwritten = None, c.stats.jwritten
    if cfg.mode == "vdc":
        new, n_jwrite = _vdc_candidate(cfg, sh, c, cur_full)
        jwritten = jwritten + n_jwrite
    step = (_fused_step if cfg.backend == "fused" else _stitched_step)(cfg, sh, sched, c, new, cur_full)
    return step, sched, jwritten


def _merge_drops(cfg: EngineConfig, carries: list[_Carry], steps: list[_Step], devices) -> list[dr.DropState]:
    """The shards' DroppedVT updates merged into the replicated structures.

    Prob: every shard probed the bits as they stood at the start of the
    iteration; now the shards' dropped and evicted masks are gathered
    full-width and inserted, twice per device as when unsharded, into one
    fresh copy of the bits (so the input state's bits stay as they were and
    no shard saw another's inserts early).  Det: ``det_overflow`` is summed
    and ``max_iter`` maxed across shards."""
    drops = [st.drop for st in steps]
    if not cfg.drop.enabled() or (cfg.drop.mode == "det" and len(drops) == 1):
        return drops
    start = [c.drop for c in carries]
    if cfg.drop.mode == "prob":
        i = carries[0].i
        to_drop = mesh_lib.all_gather([st.to_drop for st in steps], devices)
        evicted = mesh_lib.all_gather([st.evicted for st in steps], devices)
        evicted_iter = mesh_lib.all_gather([st.evicted_iter for st in steps], devices)
        merged: dict = {}  # device → the DroppedVT with every shard's inserts
        for d0, td, ev, ei in zip(start, to_drop, evicted, evicted_iter):
            dev = d0.flt.bits.device
            if dev not in merged:
                reg = d0._replace(flt=d0.flt._replace(bits=d0.flt.bits.clone()))
                reg = dr.register_(reg, i, td)
                merged[dev] = dr.register_(reg, ei, ev)
        return [d._replace(flt=merged[d0.flt.bits.device].flt, max_iter=merged[d0.flt.bits.device].max_iter)
                for d, d0 in zip(drops, start)]
    grown = mesh_lib.psum([d.det_overflow - d0.det_overflow for d, d0 in zip(drops, start)], devices)
    max_iter = mesh_lib.pmax([d.max_iter for d in drops], devices)
    return [d._replace(det_overflow=d0.det_overflow + g_, max_iter=m)
            for d, d0, g_, m in zip(drops, start, grown, max_iter)]


class _PushGroup(NamedTuple):
    """The frontier push's edge cells of the shards on one device, pushed
    together (one ``nonzero`` a device, not a shard): shard ``shards[j]``'s
    cells set column ``j·stride + x`` of one ``[Q, len(shards)·stride]``
    mask, ``x`` their destination in its block and ``stride`` the block
    width plus the spare segment of foreign cells (unsharded: none)."""

    shards: list[int]
    src: Tensor
    valid: Tensor
    dst: Tensor
    stride: int


def _push_groups(shards: list[_Shard], devices) -> list[_PushGroup]:
    """The sweep's push groups, built once a sweep (the cells do not move
    inside it)."""
    by_device: dict = {}
    for k, d in enumerate(devices):
        by_device.setdefault(d, []).append(k)
    n = shards[0].state.cur.shape[1]
    if len(shards) == 1:
        g = shards[0].g
        return [_PushGroup([0], g.src, g.valid, g.dst, n)]
    groups = []
    for ks in by_device.values():
        cat = (lambda xs: xs[0]) if len(ks) == 1 else torch.cat
        groups.append(_PushGroup(
            ks, cat([shards[k].g.src for k in ks]), cat([shards[k].g.valid for k in ks]),
            cat([shards[k].dst + j * (n + 1) for j, k in enumerate(ks)]), n + 1,
        ))
    return groups


def _push(groups: list[_PushGroup], changed_full: list[Tensor], num_local: int) -> list[Tensor]:
    """Every shard's pushed frontier (δD direct rule) from the gathered
    changed mask: one :func:`_push_cells` a device."""
    out: list = [None] * len(changed_full)
    for grp in groups:
        changed = changed_full[grp.shards[0]]
        pushed = _push_cells(changed, grp.src, grp.valid, grp.dst, len(grp.shards) * grp.stride)
        blocks = pushed.view(pushed.shape[0], len(grp.shards), grp.stride)
        for j, k in enumerate(grp.shards):
            out[k] = blocks[:, j, :num_local]
    return out


def _next_carry(c: _Carry, body: tuple[_Step, Tensor, Tensor], pushed: Tensor,
                prev: Tensor | None, drop: dr.DropState, bin_i: int) -> _Carry:
    """A shard's carry into the next iteration, after the collectives:
    its frontier (``pushed`` from the gathered changed mask), its stats
    advanced (iteration i in bin ``bin_i``)."""
    st, sched, jwritten = body
    # | changed: carry a changed vertex's own next value
    frontier_next = pushed | st.changed
    n_sched = _count(sched)
    sched_sizes = c.stats.sched_sizes.clone()
    sched_sizes[bin_i] += n_sched
    frontier_sizes = c.stats.frontier_sizes.clone()
    frontier_sizes[bin_i] += _count(frontier_next)
    stats = c.stats._replace(
        iters_run=c.stats.iters_run + 1,
        scheduled=c.stats.scheduled + n_sched,
        changed=c.stats.changed + _count(st.changed),
        repairs=c.stats.repairs + _count(st.repair),
        written=c.stats.written + _count(st.to_store),
        removed=c.stats.removed + _count(st.vanish),
        dropped=c.stats.dropped + _count(st.to_drop),
        jwritten=jwritten,
        sched_sizes=sched_sizes,
        frontier_sizes=frontier_sizes,
    )
    return _Carry(
        i=c.i + 1,
        cur=st.cur,
        cur_old=st.old,
        stale_old=st.stale,
        frontier=frontier_next,
        changed_prev=st.changed if prev is None else prev,
        dstore=st.dstore,
        jstore=c.jstore,
        drop=drop,
        repair_counts=c.repair_counts + st.repair.to(torch.int32),
        stats=stats,
        owned=True,  # every step returns new stores or updates owned ones
    )


def _sweep(cfg: EngineConfig, shards: list[_Shard], devices) -> tuple[list[EngineState], MaintainStats]:
    """The maintenance loop over the shards of a mesh (one shard:
    unsharded).  Returns each shard's new state and the summed stats: the
    one-block case of :func:`_sweep_blocks`.

    Each iteration gathers the exact front once, runs every shard's body,
    then the collectives: the DroppedVT merge, the changed mask gathered for
    the frontier push (VDC: also the rescheduled union for the J gate),
    and the loop scalars reduced on the first shard's device.

    VDC: the J store is cloned once here and the sweep upserts the written
    rows into the clone in place (``diffstore.upsert_rows_``), so the input
    state stays as it was and no iteration copies the whole ``[Q, E_cap,
    S_J]`` store; the implicit J from D_0 (``j0``) is computed once.

    Continue while work is scheduled (frontier/dirty) AND the sweep can still
    mutate the store: mutations happen only at i ≤ horizon+1 (an in-neighbour
    change point at j feeds a consumer at j+1, and fresh writes at i extend
    the horizon to ≥ i).  Dropped change points still anchor the horizon
    (they must be swept past so `cur` picks up their repaired values); with
    dropping off ``drop.max_iter`` stays -1.  i == 1 always runs when
    anything is dirty.
    """
    states, stats = _sweep_blocks(cfg, [shards], [devices])
    return states[0], stats[0]


def _first_carries(cfg: EngineConfig, shards: list[_Shard], devices) -> list[_Carry]:
    """A block's carries into iteration 1 (VDC: its shards get their
    padded dirty mask and ``j0``, in place in ``shards``)."""
    vdc = cfg.mode == "vdc"
    init_full = mesh_lib.all_gather([sh.state.init for sh in shards], devices)
    carries = []
    for k, (sh, init_f) in enumerate(zip(shards, init_full)):
        dev = sh.dirty.device
        zeros = torch.zeros(sh.dirty.shape, dtype=torch.bool, device=dev)
        jstore = None
        if vdc:
            jstore = ds.DiffStore(*(x.clone() for x in sh.state.jstore))
            pad = torch.zeros((sh.dirty.shape[0], 1), dtype=torch.bool, device=dev)
            shards[k] = sh._replace(dirty_pad=torch.cat([sh.dirty, pad], dim=1),
                                    j0=edge_messages(cfg, init_f, sh.g))  # implicit J from D_0
        carries.append(_Carry(
            i=1,
            cur=sh.state.init,
            cur_old=sh.state.init,
            stale_old=zeros,
            frontier=zeros,
            # VDC: over every vertex (J's sources are global)
            changed_prev=(torch.zeros((zeros.shape[0], cfg.num_vertices), dtype=torch.bool, device=dev)
                          if vdc else zeros),
            dstore=sh.state.dstore,
            jstore=jstore,
            drop=sh.state.drop,
            repair_counts=sh.state.repair_counts,
            stats=zeros_stats(dev),
            owned=False,
        ))
    return carries


def _block_iteration(cfg: EngineConfig, shards: list[_Shard], devices, carries: list[_Carry],
                     groups: list[_PushGroup]) -> tuple[list[_Carry], Tensor, Tensor]:
    """One IFE iteration of a block's shards: (their next carries, whether
    any is still live, whether any stored a point), the two on the block's
    first device."""
    i = carries[0].i
    # the one O(V) exchange: the exact front, for messages from remote sources
    cur_full = mesh_lib.all_gather([c.cur for c in carries], devices)
    bodies = [_shard_body(cfg, sh, c, cf) for sh, c, cf in zip(shards, carries, cur_full)]
    del cur_full
    steps = [b[0] for b in bodies]
    drops = _merge_drops(cfg, carries, steps, devices)
    pushed = _push(groups, mesh_lib.all_gather([st.changed for st in steps], devices),
                   shards[0].state.cur.shape[1])
    prev = [None] * len(carries)
    if cfg.mode == "vdc":
        # a vertex rescheduled at i may have reverted to its old value
        # without reading as changed; its out-edges' stored messages must
        # be re-checked at i+1 all the same, or a stale J row outlives it
        prev = mesh_lib.all_gather([st.changed | sched for st, sched, _ in bodies], devices)
    bin_i = min(i - 1, ITER_TRACE - 1)  # iteration i lands in bin i-1 (clamped)
    nxt = [_next_carry(c, body, pushed[k], prev[k], drops[k], bin_i)
           for k, (c, body) in enumerate(zip(carries, bodies))]
    lives = [c.frontier.any() | sh.dirty.any() for sh, c in zip(shards, nxt)]
    any_store = mesh_lib.por([st.to_store.any() for st in steps], devices)[0]
    return nxt, mesh_lib.por(lives, devices)[0], any_store


def _sweep_blocks(cfg: EngineConfig, blocks: list[list[_Shard]], devices: list[list]
                  ) -> tuple[list[list[EngineState]], list[MaintainStats]]:
    """The maintenance loop over query blocks, each a vertex-sharded sweep
    of its own (``blocks[b]``: its shards, ``devices[b]`` their devices;
    ``cfg.num_queries`` is a block's).  Returns each block's shard states
    and stats.

    The blocks share the loop's control: ``live``, the horizon and
    ``drop.max_iter`` are reduced over every block before the one host sync
    of an iteration, so each block runs exactly the iterations the whole
    query axis would run in one sweep (a block's own horizon would stop it
    early, and its dirty vertices, rerun at every live iteration, would
    count differently).  Nothing else crosses between blocks; one block's
    iteration runs, and frees its temporaries, before the next one's."""
    carries = [_first_carries(cfg, shards, devs) for shards, devs in zip(blocks, devices)]
    groups = [_push_groups(shards, devs) for shards, devs in zip(blocks, devices)]
    all_shards = [sh for shards in blocks for sh in shards]
    all_devices = [d for devs in devices for d in devs]
    firsts = [devs[0] for devs in devices]
    # the loop scalars, replicated in the reference, live on the first device
    horizon = mesh_lib.pmax([stored_horizon(sh.state.dstore) for sh in all_shards], all_devices)[0]
    live = mesh_lib.por([sh.dirty.any() for sh in all_shards], all_devices)[0]
    while carries[0][0].i <= cfg.max_iters:
        i = carries[0][0].i
        max_iter = mesh_lib.pmax([c[0].drop.max_iter for c in carries], firsts)[0]
        # the one host sync of an iteration: all loop scalars at once
        live_h, horizon_h, max_iter_h = torch.stack([live.to(torch.int32), horizon, max_iter]).tolist()
        if not (live_h and (i == 1 or i <= max(horizon_h, max_iter_h) + 1)):
            break
        lives, stores = [], []
        for b, (shards, devs) in enumerate(zip(blocks, devices)):
            # (rebinding the block's carries frees the old ones before the next block runs)
            carries[b], block_live, block_store = _block_iteration(cfg, shards, devs, carries[b], groups[b])
            lives.append(block_live)
            stores.append(block_store)
        live = mesh_lib.por(lives, firsts)[0]
        any_store = mesh_lib.por(stores, firsts)[0]
        horizon = torch.where(any_store, horizon.clamp(min=i), horizon)

    states, stats = [], []
    for shards, devs, block in zip(blocks, devices, carries):
        # per-shard partial sums → the block's; iters_run is the same on every shard
        summed = [mesh_lib.psum([getattr(c.stats, f) for c in block], devs)[0] for f in MaintainStats._fields]
        st = MaintainStats(*summed)._replace(iters_run=block[0].stats.iters_run)
        # Det-Drop record loss this sweep (replicated after the merges)
        stats.append(st._replace(det_overflow=block[0].drop.det_overflow - shards[0].state.drop.det_overflow))
        out = []
        for sh, c in zip(shards, block):
            # a sweep with nothing dirty runs no iteration and changes nothing: its
            # answers stay the last sweep's (the carry's `cur` is still D_0; the
            # reference returns that, ROADMAP Queue 3)
            cur = c.cur if c.i > 1 else sh.state.cur
            out.append(sh.state._replace(
                dstore=c.dstore, jstore=c.jstore, drop=c.drop, cur=cur, repair_counts=c.repair_counts
            ))
        states.append(out)
    return states, stats


def _dirty_2d(cfg: EngineConfig, dirty: Tensor) -> Tensor:
    """Normalize a [V] vertex mask to the per-query [Q, V] schedule seed."""
    dirty = dirty.to(torch.bool)
    if dirty.ndim == 1:
        dirty = dirty[None, :].expand(cfg.num_queries, -1)
    return dirty


def _make_shard(cfg: EngineConfig, state: EngineState, g: GraphArrays, dirty: Tensor, off: int,
                dst: Tensor | None) -> _Shard:
    return _Shard(state=state, g=g, dirty=dirty, off=off, dst=dst,
                  degree=_degree(g, off) if cfg.drop.enabled() else None)


def maintain(
    cfg: EngineConfig, state: EngineState, g: GraphArrays, dirty: Tensor
) -> tuple[EngineState, MaintainStats]:
    """One maintenance sweep after a δE batch (or initial computation).

    ``dirty`` is the bool mask of vertices whose in-edge set (or, for
    degree-derived weights, whose incoming message weights) changed — [V]
    (broadcast to every query) or [Q, V].  For the initial computation pass
    ``dirty = ones`` with an empty store — the sweep then *is* the static IFE
    run, recording change points as it goes.  The one-shard case of
    :func:`maintain_sharded`.
    """
    states, stats = maintain_sharded(cfg, [state.cur.device], [state], [g], dirty)
    return states[0], stats


def maintain_sharded(
    cfg: EngineConfig, devices, states: list[EngineState], gs: list[GraphArrays], dirty: Tensor,
) -> tuple[list[EngineState], MaintainStats]:
    """:func:`maintain` with every per-vertex carry split over the shards
    of a mesh (``devices``: shard k's device): ``states``/``gs`` hold each
    shard's block (the edge cells in the :class:`ShardIndex` layout),
    ``dirty`` is global ([V] or [Q, V]).  Returns each shard's new state and
    the global stats.  One shard is the unsharded sweep."""
    return _sweep(cfg, _block_shards(cfg, devices, states, gs, dirty), devices)


def _block_shards(cfg: EngineConfig, devices, states: list[EngineState], gs: list[GraphArrays],
                  dirty: Tensor) -> list[_Shard]:
    dirty = _dirty_2d(cfg, dirty)
    n = cfg.num_vertices // len(states)
    return [
        _make_shard(cfg, st, g, dirty[:, k * n:(k + 1) * n].to(dev), k * n,
                    None if len(states) == 1 else _local_dst(g.dst, k * n, n))
        for k, (st, g, dev) in enumerate(zip(states, gs, devices))
    ]


def maintain_blocks(
    cfg: EngineConfig, devices: list, states: list[list[EngineState]], gs: list[list[GraphArrays]],
    dirty: list[Tensor],
) -> tuple[list[list[EngineState]], list[MaintainStats]]:
    """:func:`maintain_sharded` over blocks of the query axis that share the
    loop's control (:func:`_sweep_blocks`): block ``b`` sweeps
    ``cfg.num_queries`` queries over the shards ``states[b]``/``gs[b]`` on
    ``devices[b]``, seeded by ``dirty[b]`` ([V], or its rows [Q_b, V]).
    Returns each block's shard states and its stats; every block runs the
    iterations one sweep of all the blocks' queries runs, so the blocks'
    stats combine into that sweep's (:func:`combine_stats`)."""
    blocks = [_block_shards(cfg, devs, sts, g, d) for devs, sts, g, d in zip(devices, states, gs, dirty)]
    return _sweep_blocks(cfg, blocks, [list(d) for d in devices])


def combine_stats(parts: list[MaintainStats]) -> MaintainStats:
    """The stats of query blocks swept together (:func:`maintain_blocks`)
    as one sweep's: ``iters_run`` their max (they are equal), every other
    counter and both per-iteration series summed, on the first block's
    device."""
    dev = parts[0].iters_run.device
    out = [torch.stack([getattr(p, f).to(dev) for p in parts]).amax(0) if f == "iters_run"
           else torch.stack([getattr(p, f).to(dev) for p in parts]).sum(0, dtype=torch.int32)
           for f in MaintainStats._fields]
    return MaintainStats(*out)


def shard_graph_arrays(snap: GraphSnapshot, index: ShardIndex, devices, nbr: np.ndarray | None = None,
                       ell_w: np.ndarray | None = None) -> list[GraphArrays]:
    """Each shard's device graph: its edge cells (``index``'s layout), its
    block of in-degrees and ELL rows (neighbour ids stay global: the kernels
    gather from the full front), and every vertex's out-degree."""
    src, dst, w, valid = index.edge_arrays(snap)
    out_degree = mesh_lib.replicate(torch.from_numpy(snap.out_degree), devices)
    c, nb = index.shard_capacity, index.vertices_per_shard
    gs = []
    for k, dev in enumerate(devices):
        cells, rows = slice(k * c, (k + 1) * c), slice(k * nb, (k + 1) * nb)

        def put(x: np.ndarray | None) -> Tensor | None:
            return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        gs.append(GraphArrays(
            src=put(src[cells]), dst=put(dst[cells]), weight=put(w[cells]), valid=put(valid[cells]),
            out_degree=out_degree[k], in_degree=put(snap.in_degree[rows]),
            nbr=put(None if nbr is None else nbr[rows]), ell_w=put(None if ell_w is None else ell_w[rows]),
        ))
    return gs


def shed_slot(cfg: EngineConfig, state: EngineState, g: GraphArrays, slot: int, off: int = 0) -> EngineState:
    """Re-audit ONE query slot's stored diffs under its (just rewritten)
    selection params: the points the escalated policy selects move from the
    diff store into the DroppedVT (an 8 B change point becomes a ≤ 4 B Det
    record, or Bloom bits), exactly as if they had been dropped at write
    time.  ``cur`` (the answers) is untouched; the sweep repairs dropped
    points on access (§5).

    The reference audits every ``[Q, V, S]`` entry and masks to the slot;
    here only the slot's row is audited — the coin is stateless in (seed, q,
    v, i), so the result is bit-equal — and its D-store row, Det rows or
    Bloom row are rewritten in place.  Shed points register one store
    column at a time, as in the reference (the Det store is keyed by
    (q, v), so several iterations of one vertex cannot land in one upsert);
    columns with nothing to shed are skipped (one host sync).  On a
    shard, ``state``/``g`` are its block and ``off`` its first vertex: the
    coin and the Bloom key see global ids, so a shed is bit-identical under
    any sharding.
    """
    drop = state.drop
    if drop.params is None or not bool(state.active[slot]):
        return state
    row = slice(slot, slot + 1)
    iters, vals, count = (x[row] for x in state.dstore)  # views of the slot's rows
    params = dr.DropParams(*(x[row] for x in drop.params))
    mask = dr.select_stored_to_drop(params, _degree(g, off), iters, ds.IMAX, q_ids=slot, v_offset=off)
    sub = dr.DropState(
        det=None if drop.det is None else ds.DiffStore(*(x[row] for x in drop.det)),
        flt=None if drop.flt is None else drop.flt._replace(bits=drop.flt.bits[row]),
        det_overflow=drop.det_overflow,
        max_iter=drop.max_iter,
    )
    for col in mask.any(dim=1)[0].nonzero().flatten().tolist():
        sub = dr.register_(sub, iters[..., col], mask[..., col], q_offset=slot, v_offset=off)
    # remove them from the store, keeping each row sorted
    it = torch.where(mask, ds.IMAX, iters)
    val = torch.where(mask, 0.0, vals)
    order = torch.argsort(it, dim=-1, stable=True)
    iters.copy_(torch.gather(it, -1, order))
    vals.copy_(torch.gather(val, -1, order))
    count.copy_((iters < ds.IMAX).sum(dim=-1, dtype=torch.int32))
    return state._replace(drop=drop._replace(det_overflow=sub.det_overflow, max_iter=sub.max_iter))


def reassemble(
    cfg: EngineConfig, state: EngineState, g: GraphArrays, upto: int | None = None
) -> Tensor:
    """Repair-aware reassembly of D at iteration ``upto`` (paper's Access).

    Bounded forward repair: walk iterations 1..upto; stored points are
    exact, dropped points are recomputed from the exact previous front.
    """
    upto = cfg.max_iters if upto is None else upto
    cur = state.init
    for i in range(1, upto + 1):
        has, val = ds.value_at(state.dstore, i)
        if cfg.drop.enabled():
            dropped = dr.dropped_at(state.drop, i, cfg.num_vertices)
            new = ife_step(cfg, cur, g)
            cur = torch.where(has, val, torch.where(dropped, new, cur))
        else:
            cur = torch.where(has, val, cur)
    return cur


def nbytes_accounted(cfg: EngineConfig, state: EngineState) -> int:
    """Difference-entry bytes, the paper's memory metric (8 B per diff:
    4 B iteration + 4 B state) of the D store and the J store, plus the
    DroppedVT per §5.1 costings (the selection rows and Bloom rows of live
    slots only)."""
    total = int(state.dstore.count.sum()) * 8
    if state.jstore is not None:
        total += int(state.jstore.count.sum()) * 8
    if cfg.drop.enabled():
        total += state.drop.nbytes_accounted(state.active)
    return total


# --------------------------------------------------------------------------- batched updates
class UpdateBatch(NamedTuple):
    """Fixed-shape device encoding of ≤ B resolved edge updates.

    One row per touched edge slot, holding the slot's *final* contents after
    the whole chunk (the host coalesces, so scatter order never matters).
    Padding rows carry out-of-range indices — slot == E_cap, vertex == V,
    ell_row == V — which :func:`batched_step` masks out.
    """

    slot: Tensor  # int32 [B] — edge slot; E_cap padding
    src: Tensor  # int32 [B] — final slot source
    dst: Tensor  # int32 [B] — final slot destination
    weight: Tensor  # f32  [B] — final slot weight
    valid: Tensor  # bool [B] — final slot validity
    dirty_v: Tensor  # int32 [B] — endpoint to dirty (δE direct rule); V padding
    touched_src: Tensor  # int32 [B] — update source (degree-retune rule); V padding
    ell_row: Tensor  # int32 [B] — ELL cell writes (ell/fused); V padding
    ell_col: Tensor  # int32 [B]
    ell_nbr: Tensor  # int32 [B]
    ell_w: Tensor  # f32  [B]


def _mark(n: int, idx: Tensor) -> Tensor:
    """bool [n] with ``idx`` set; ``idx == n`` (padding) lands on a sentinel
    cell that is sliced off."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out[idx.long()] = True
    return out[:n]


def batched_step(
    cfg: EngineConfig, state: EngineState, g: GraphArrays, upd: UpdateBatch
) -> tuple[EngineState, GraphArrays, MaintainStats]:
    """Fold one δE chunk into the graph arrays and run ONE maintenance sweep.

    The device-side twin of ``DiffIFE.apply_updates``: edge scatter, degree
    refresh, dirty-mask construction and the sweep.  The edge and ELL
    buffers of ``g`` are written in place and returned (the reference
    donates them); the engine state is not modified.  The one-shard case of
    :func:`batched_step_sharded`.
    """
    states, gs, stats = batched_step_sharded(cfg, [state.cur.device], [state], [g], upd)
    return states[0], gs[0], stats


def batched_step_sharded(
    cfg: EngineConfig, devices, states: list[EngineState], gs: list[GraphArrays], upd: UpdateBatch,
) -> tuple[list[EngineState], list[GraphArrays], MaintainStats]:
    """:func:`batched_step` over the shards of a mesh (``devices``: shard
    k's device).  The (replicated) chunk is scattered to the owning shards
    — each shard localizes the chunk's indices (``upd.slot`` is the linear
    :class:`ShardIndex` cell, or the graph slot unsharded; ELL rows and
    dirty vertices are global) and drops the rows it does not own; padding
    rows own nothing — then the sweep runs.  Out-degrees are summed across
    shards (any shard may hold out-edges of any source); in-degrees are a
    shard's own.  Each shard's edge and ELL buffers are written in place
    and returned."""
    v = cfg.num_vertices
    sharded = len(states) > 1
    n = v // len(states)
    cells = gs[0].src.shape[0]  # edge cells per shard
    spare = 1 if sharded else 0  # a segment for foreign destinations
    upds = mesh_lib._per_device(devices, lambda d: UpdateBatch(*(x.to(d) for x in upd)))
    parts, out_parts = [], []
    for k, (g, u) in enumerate(zip(gs, upds)):
        off = k * n
        slot = u.slot.long() - k * cells
        keep = (slot >= 0) & (slot < cells)  # foreign and padding rows scatter nothing
        slot = slot[keep]
        src = g.src.index_put_((slot,), u.src[keep])
        dst = g.dst.index_put_((slot,), u.dst[keep])
        weight = g.weight.index_put_((slot,), u.weight[keep])
        valid = g.valid.index_put_((slot,), u.valid[keep])
        # degrees recomputed from the edge list — immune to host/device drift
        live = valid.to(torch.int32)
        out_parts.append(torch.zeros(v, dtype=torch.int32, device=live.device).index_add_(0, src, live))
        dst_l = _local_dst(dst, off, n) if sharded else dst
        in_degree = torch.zeros(n + spare, dtype=torch.int32, device=live.device).index_add_(0, dst_l, live)[:n]
        if cfg.backend in ("ell", "fused"):
            row = u.ell_row.long() - off
            ok = (row >= 0) & (row < n)  # foreign and padding rows (ell_row == V) write nothing
            cell = (row[ok], u.ell_col[ok].long())
            g.nbr.index_put_(cell, u.ell_nbr[ok])
            g.ell_w.index_put_(cell, u.ell_w[ok])
        dv = u.dirty_v.long() - off
        dirty = _mark(n, torch.where((dv >= 0) & (dv < n), dv, n))
        if cfg.weight_from_degree:
            # outdeg(u) changed → every out-message of u retunes (δE dirty rule)
            hit = (_mark(v, u.touched_src).index_select(0, src) & valid).to(torch.int32)
            retuned = torch.zeros(n + spare, dtype=torch.int32, device=hit.device).index_add_(0, dst_l, hit)
            dirty = dirty | (retuned[:n] > 0)
        parts.append((src, dst, weight, valid, in_degree, g.nbr, g.ell_w, dirty, dst_l))
    out_degree = mesh_lib.psum(out_parts, devices)
    gs2, shards = [], []
    for k, (st, (src, dst, weight, valid, in_degree, nbr, ell_w, dirty, dst_l)) in enumerate(zip(states, parts)):
        g2 = GraphArrays(src, dst, weight, valid, out_degree[k], in_degree, nbr, ell_w)
        gs2.append(g2)
        shards.append(_make_shard(cfg, st, g2, dirty[None, :].expand(cfg.num_queries, -1), k * n,
                                  dst_l if sharded else None))
    new_states, stats = _sweep(cfg, shards, devices)
    return new_states, gs2, stats


# --------------------------------------------------------------------------- placement on a mesh
def state_shardings(state: EngineState, mesh: mesh_lib.DataMesh) -> EngineState:
    """Where each leaf of a global state goes on ``mesh`` (the reference's
    ``_state_pspecs``): the per-vertex leaves — and VDC's J rows, over the
    edge cells — split along their key axis; the Bloom bits, the selection
    rows, ``active``/``join_mat`` and the scalars are replicated."""
    split, rep = mesh_lib.Sharding(mesh, 1), mesh_lib.Sharding(mesh)

    def store(x):
        return None if x is None else ds.DiffStore(split, split, split)

    drop = state.drop
    return EngineState(
        dstore=store(state.dstore),
        jstore=store(state.jstore),
        drop=dr.DropState(
            det=store(drop.det),
            flt=None if drop.flt is None else bloom_lib.BloomFilter(rep, drop.flt.num_hashes),
            det_overflow=rep,
            max_iter=rep,
            params=None if drop.params is None else dr.DropParams(*([rep] * len(dr.DropParams._fields))),
        ),
        init=split,
        cur=split,
        repair_counts=split,
        active=rep,
        join_mat=None if state.join_mat is None else rep,
    )


def place_state(tree, specs) -> list:
    """Split a global tree (an :class:`EngineState` or a part of one) into
    one tree per shard along ``specs`` (:func:`state_shardings`)."""
    if isinstance(specs, mesh_lib.Sharding):
        return specs.place(tree)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        fields = [place_state(x, sp) for x, sp in zip(tree, specs)]
        n = next(len(f) for f in fields if isinstance(f, list))
        return [type(specs)(*(f[k] if isinstance(f, list) else f for f in fields)) for k in range(n)]
    return specs  # None, or a plain value (num_hashes) that every shard repeats


def reshard(state: EngineState, mesh: mesh_lib.DataMesh) -> list[EngineState]:
    """A global state (the J store in the mesh's cell layout) split over
    ``mesh``: one state per shard (:func:`state_shardings`)."""
    return place_state(state, state_shardings(state, mesh))


def gather_state(states: list[EngineState], mesh: mesh_lib.DataMesh, device) -> EngineState:
    """The global state of a sharded engine, assembled on ``device``:
    split leaves concatenated along their key axis (the J store stays in
    the cell layout), replicated leaves copied from the first shard."""

    def gather(parts, spec):
        if spec is None:
            return None
        if isinstance(spec, mesh_lib.Sharding):
            if spec.axis is None:
                return parts[0].to(device, copy=True)
            return torch.cat([p.to(device) for p in parts], dim=spec.axis)
        if isinstance(spec, tuple) and hasattr(spec, "_fields"):
            return type(spec)(*(gather([getattr(p, f) for p in parts], getattr(spec, f))
                                for f in spec._fields))
        return spec

    return gather(states, state_shardings(states[0], mesh))


def _sum_stats(a: MaintainStats, b: MaintainStats) -> MaintainStats:
    return MaintainStats(*(x + y for x, y in zip(a, b)))


def _span_stats(stats: MaintainStats | None) -> dict:
    """Sweep attribution for trace spans: scalar counters plus the
    per-iteration size series trimmed to the iterations actually run."""
    if stats is None:
        return {}
    out = {k: int(getattr(stats, k)) for k in MaintainStats.SCALAR_FIELDS}
    n = min(max(out["iters_run"], 0), ITER_TRACE)
    out["sched_sizes"] = [int(x) for x in stats.sched_sizes[:n]]
    out["frontier_sizes"] = [int(x) for x in stats.frontier_sizes[:n]]
    return out


def _host_copy(x: Tensor) -> np.ndarray:
    """A numpy copy of ``x`` that later in-place slot edits cannot reach
    (``.cpu()`` of a CPU tensor is the tensor itself)."""
    return x.detach().to("cpu", copy=True).numpy()


# --------------------------------------------------------------------------- host-facing wrapper
class DiffIFE:
    """Continuous-query processor: owns the dynamic graph + engine state.

    ``DiffIFE`` is the host driver; device work happens in the functions
    above.  Two ingestion paths:

    * :meth:`apply_updates` — per-batch host path: mutate the host graph,
      re-upload the device view, run one sweep.
    * :meth:`apply_updates_batched` — the throughput path: updates are folded
      in fixed-shape chunks of ``batch_capacity`` through :func:`batched_step`,
      so the graph and stores never leave the device.

    With ``cfg.backend`` ``"ell"`` or ``"fused"`` the bucketed in-adjacency
    rides along; its
    width ``D`` is kept fixed across updates (host :class:`EllIndex` mirror)
    and grows geometrically — with a full re-upload — only when a vertex's
    in-degree outruns it.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.DataMesh` of N > 1
    shards) every per-vertex carry splits by destination vertex over the
    shards and both ingestion paths run the sharded sweep
    (:func:`maintain_sharded` / :func:`batched_step_sharded`, of which the
    unsharded engine runs the one-shard case); ``states`` and ``gs`` hold
    each shard's block, on its device.  The edge list moves
    into the :class:`ShardIndex` cell layout (cells grouped by owning shard,
    host mirror kept in sync per chunk) and grows geometrically per shard —
    with a full re-upload, and VDC's J rows permuted into the new cells —
    when a shard's cells run out.  ``state`` then reads as a global copy.

    **Query slot pool**: the leading Q axis is a padded pool of query slots
    gated by ``state.active``.  :meth:`register_slots` claims free slots
    (doubling the pool when none is left) and computes the new queries'
    traces in one maintenance sweep whose per-query dirty mask seeds only
    the new rows; :meth:`deregister_slot` empties a slot's rows and returns
    the accounted bytes freed.  These edits write the slot's rows in place,
    on every shard.

    ``device=None`` runs on the CUDA device (and raises without one);
    ``device="cpu"`` runs the plain PyTorch versions.  With a mesh, the
    device is the mesh's first.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        graph: DynamicGraph,
        init: np.ndarray | Tensor,
        *,
        batch_capacity: int = 32,
        mesh: mesh_lib.DataMesh | None = None,
        active=None,
        drop_rows: list[dr.DropConfig] | None = None,
        join_rows: list[bool] | None = None,
        device=None,
    ) -> None:
        mesh = None if mesh is None else mesh_lib.as_data_mesh(mesh)  # vertices over `data` alone
        self.device = resolve_device(device) if mesh is None else mesh_lib.mesh_device(mesh, device)
        self.mesh = mesh
        self.num_shards = 1 if mesh is None else mesh.size
        self.devices = (self.device,) if mesh is None else mesh.devices
        if cfg.num_vertices % self.num_shards:
            raise ValueError(
                f"num_vertices {cfg.num_vertices} not divisible by the mesh's data axis "
                f"({self.num_shards})"
            )
        self.cfg = cfg
        self.graph = graph
        self.batch_capacity = int(batch_capacity)
        self._ell_width = 0
        self._ell_index: EllIndex | None = None
        self._shard_index: ShardIndex | None = None
        self.gs = self._device_graphs(graph.snapshot())
        num_rows = self._shard_index.size if self._shard_index is not None else graph.capacity
        # a copy: slot edits write rows of the state in place
        init = torch.as_tensor(init, dtype=torch.float32).to(self.device, copy=True)
        self.states = self._place(make_state(
            cfg, init, num_rows, active=active, drop_rows=drop_rows, join_rows=join_rows
        ))
        # descending, so pop() hands out the lowest free slot first
        self._free_slots: list[int] = sorted(
            (q for q in range(cfg.num_queries) if active is not None and not bool(active[q])),
            reverse=True,
        )
        self.last_stats: MaintainStats | None = None
        # DroppedVT records lost to Det-Drop evictions during sheds (a shed
        # runs between sweeps, so MaintainStats.det_overflow never sees them)
        self.det_overflow_shed = 0
        # cumulative scheduled vertex-reruns across all sweeps
        self._sched_total = 0
        # initial computation: every vertex dirty, empty store; an
        # all-inactive pool (the session's deferred register) skips it
        if active is None or bool(np.asarray(active).any()):
            self._run_counted(np.ones(cfg.num_vertices, dtype=bool))

    # ------------------------------------------------------------ shards
    @property
    def sharded(self) -> bool:
        return self.num_shards > 1

    @property
    def state(self) -> EngineState:
        """The engine state.  Sharded: a global copy assembled on the first
        device, the J store in the edge-slot layout (for reading: edits go
        to ``states``)."""
        return self.states[0] if not self.sharded else self._global_state(self.device)

    @state.setter
    def state(self, st: EngineState) -> None:
        """Replace the state.  Sharded: a global state in the getter's
        layout (the J store in the edge-slot layout), moved into this
        mesh's cells and split over the shards."""
        if self.sharded and st.jstore is not None:
            st = st._replace(jstore=self._to_cells(st.jstore))
        self.states = self._place(st)

    def _place(self, st: EngineState) -> list[EngineState]:
        """A global state whose J store is in the cell layout, split over
        the shards (unsharded: the state itself)."""
        return [st] if not self.sharded else reshard(st, self.mesh)

    @property
    def g(self) -> GraphArrays:
        """The device graph (unsharded engines; a sharded one holds ``gs``)."""
        if self.sharded:
            raise AttributeError("a sharded engine holds one device graph per shard: DiffIFE.gs")
        return self.gs[0]

    @g.setter
    def g(self, g: GraphArrays) -> None:
        if self.sharded:
            raise AttributeError("a sharded engine holds one device graph per shard: DiffIFE.gs")
        self.gs = [g]

    def _block(self, k: int) -> slice:
        """Shard k's vertex block."""
        n = self.cfg.num_vertices // self.num_shards
        return slice(k * n, (k + 1) * n)

    def _global_state(self, device) -> EngineState:
        """A sharded engine's state assembled on ``device``, the J store in
        the edge-slot layout ``[Q, E_cap, S_J]`` (a deleted slot's row comes
        back empty)."""
        st = gather_state(self.states, self.mesh, device)
        if st.jstore is not None:
            cells = torch.from_numpy(self._shard_index.cell_of).to(device)  # slot → cell, -1: none
            st = st._replace(jstore=ds.gather_rows(st.jstore, cells))
        return st

    def _to_cells(self, jstore: ds.DiffStore) -> ds.DiffStore:
        """A J store in the edge-slot layout scattered into this mesh's cell
        layout (cells without a live edge start empty)."""
        idx = np.full(self._shard_index.size, -1, np.int64)
        slots, lin = self._shard_index.cells()
        idx[lin] = slots
        return ds.gather_rows(jstore, torch.from_numpy(idx).to(jstore.iters.device))

    # ------------------------------------------------------------ device views
    def _device_graphs(self, snap: GraphSnapshot) -> list[GraphArrays]:
        """Every shard's device graph (unsharded: the one)."""
        return self._device_graphs_sharded(snap) if self.sharded else [self._device_graph(snap)]

    def _device_graph(self, snap: GraphSnapshot) -> GraphArrays:
        if self.cfg.backend in ("ell", "fused"):
            g = GraphArrays.from_snapshot(
                snap, backend=self.cfg.backend, ell_min_width=self._ell_width, device=self.device
            )
            self._ell_width = g.ell_width
            self._ell_index = EllIndex(snap, self._ell_width)
            return g
        return GraphArrays.from_snapshot(snap, device=self.device)

    def _device_graphs_sharded(self, snap: GraphSnapshot) -> list[GraphArrays]:
        """Each shard's device graph (:func:`shard_graph_arrays`) in the
        :class:`ShardIndex` layout."""
        if self._shard_index is None:
            self._shard_index = ShardIndex(snap, self.num_shards)
        nbr = ell_w = None
        if self.cfg.backend in ("ell", "fused"):
            nbr, ell_w, self._ell_width = snap.to_ell(min_width=self._ell_width)
            self._ell_index = EllIndex(snap, self._ell_width)
        return shard_graph_arrays(snap, self._shard_index, self.devices, nbr, ell_w)

    def _shard_sync(self, ops, snap: GraphSnapshot | None = None) -> list | None:
        """Fold resolved ops into the shard index; regrow on overflow.

        Returns the coalesced cell writes, or None when the index had to be
        rebuilt (the caller must then re-upload the full edge layout).  The
        snapshot is taken on the overflow path only, so the per-chunk path
        stays O(B) on the host."""
        try:
            return self._shard_index.writes_for(ops)
        except ShardOverflow:
            self._regrow_shards(snap if snap is not None else self.graph.snapshot())
            return None

    def _regrow_shards(self, snap: GraphSnapshot) -> None:
        """Rebuild the shard layout at 2× per-shard capacity.  VDC's J rows
        follow their edges into the new cells; cells without a surviving
        edge start empty (the implicit ``j0`` is exact for fresh inserts and
        vacated cells alike)."""
        old = self._shard_index
        self._shard_index = ShardIndex(snap, self.num_shards, min_capacity=old.shard_capacity * 2)
        if self.states[0].jstore is not None:
            idx = np.full(self._shard_index.size, -1, np.int64)
            slots, lin = self._shard_index.cells()
            idx[lin] = old.cell_of[slots]
            cells = ds.DiffStore(*(torch.cat([getattr(st.jstore, f).to(self.device) for st in self.states], dim=1)
                                   for f in ds.DiffStore._fields))
            jstore = ds.gather_rows(cells, torch.from_numpy(idx).to(self.device))
            parts = place_state(jstore, state_shardings(self.states[0], self.mesh).jstore)
            self.states = [st._replace(jstore=p) for st, p in zip(self.states, parts)]

    def _run(self, dirty: np.ndarray) -> MaintainStats:
        """One sweep; returns its device-side stats (``last_stats`` gets a
        host copy)."""
        dirty_t = torch.from_numpy(np.asarray(dirty, bool)).to(self.device)
        self.states, stats = maintain_sharded(self.cfg, self.devices, self.states, self.gs, dirty_t)
        self.last_stats = _stats_to_host(stats)
        return stats

    def _run_counted(self, dirty: np.ndarray) -> None:
        """_run + fold the sweep into the cumulative recompute-volume signal
        (the batched path folds its own totals, fallback sweeps included)."""
        self._run(dirty)
        self._sched_total += int(self.last_stats.scheduled)

    def _dirty_mask(self, touched, snap: GraphSnapshot) -> np.ndarray:
        dirty = np.zeros(self.cfg.num_vertices, dtype=bool)
        for (u, v) in touched:
            dirty[v] = True
            if self.cfg.weight_from_degree:
                # outdeg(src) changed → every out-message of src retunes
                dirty[snap.dst[(snap.src == u) & snap.valid]] = True
        return dirty

    # ------------------------------------------------------------- ingestion
    def apply_updates(self, updates) -> MaintainStats:
        """Ingest one δE batch and maintain all registered queries."""
        with obs_trace.span("sweep", "sweep", pid="engine:dense", shards=self.num_shards) as sp:
            ops = self.graph.apply_batch_resolved(updates)
            snap = self.graph.snapshot()
            if self.sharded:
                self._shard_sync(ops, snap)  # keep cells stable (VDC)
            self.gs = self._device_graphs(snap)
            touched = [(u, v) for (_k, _s, u, v, _w) in ops]
            self._run_counted(self._dirty_mask(touched, snap))
            sp.set(num_updates=len(ops), **_span_stats(self.last_stats))
        return self.last_stats

    def _full_sweep_fallback(self, ops, total: MaintainStats) -> MaintainStats:
        """Re-upload the full device graph and run one host-path sweep (the
        once-per-growth escape hatch of the batched stream)."""
        with obs_trace.span(
            "full_sweep_fallback", "sweep", pid="engine:dense", num_ops=len(ops)
        ):
            snap = self.graph.snapshot()
            self.gs = self._device_graphs(snap)
            touched = [(u, v) for (_k, _s, u, v, _w) in ops]
            stats = self._run(self._dirty_mask(touched, snap))
        return _sum_stats(total, stats)

    def apply_updates_batched(
        self, updates, batch_size: int | None = None
    ) -> MaintainStats:
        """Stream a δE log through :func:`batched_step_sharded` (one shard
        unsharded).

        The log is folded in fixed-shape chunks of ``batch_size`` (default:
        ``batch_capacity``); per chunk one call scatters the edge slots,
        refreshes degrees, builds the dirty mask on device and runs the
        maintenance sweep.  Returns the cumulative stats over the log.
        """
        b = int(batch_size if batch_size is not None else self.batch_capacity)
        updates = list(updates)
        total = zeros_stats(self.device)
        with obs_trace.span(
            "update_batch",
            "update_batch",
            pid="engine:dense",
            num_updates=len(updates),
            chunk_size=b,
            shards=self.num_shards,
        ) as outer:
            for lo in range(0, len(updates), b):
                ops = self.graph.apply_batch_resolved(updates[lo : lo + b])
                if not ops:
                    continue
                shard_writes = None
                if self.sharded:
                    shard_writes = self._shard_sync(ops)
                    if shard_writes is None:
                        # a shard's cells overflowed: layout regrown (J rows
                        # permuted), one full-view sweep for this chunk
                        total = self._full_sweep_fallback(ops, total)
                        continue
                ell_writes: list = []
                if self.cfg.backend in ("ell", "fused"):
                    try:
                        ell_writes = self._ell_index.writes_for(ops)
                    except EllOverflow:
                        # a vertex outran the fixed D: grow geometrically and
                        # fall back to a full-view sweep
                        self._ell_width = max(8, self._ell_width * 2)
                        total = self._full_sweep_fallback(ops, total)
                        continue
                upd = self._encode_chunk(ops, ell_writes, b, shard_writes)
                # the sweep span covers one chunk's maintenance sweep; the
                # nested dispatch span is the step call itself.  Per-chunk
                # stats stay on device (one host sync per log).
                with obs_trace.span(
                    "sweep", "sweep", pid="engine:dense", chunk_lo=lo, num_ops=len(ops)
                ):
                    with obs_trace.span(
                        "kernel_dispatch",
                        "kernel_dispatch",
                        pid="engine:dense",
                        chunk_lo=lo,
                        num_ops=len(ops),
                        backend=self.cfg.backend,
                    ):
                        self.states, self.gs, stats = batched_step_sharded(
                            self.cfg, self.devices, self.states, self.gs, upd
                        )
                    total = _sum_stats(total, stats)
            self.last_stats = _stats_to_host(total)
            outer.set(**_span_stats(self.last_stats))
        self._sched_total += int(self.last_stats.scheduled)
        return self.last_stats

    def _encode_chunk(self, ops, ell_writes, b: int, shard_writes=None) -> UpdateBatch:
        """Host O(B) encode of resolved ops → fixed-shape UpdateBatch (the
        slots are linear cells of the shard layout when sharded)."""
        if len(ops) > b:
            raise ValueError(f"chunk of {len(ops)} ops exceeds capacity {b}")
        v = self.cfg.num_vertices
        cap = self._shard_index.size if shard_writes is not None else self.graph.capacity
        slot = np.full(b, cap, np.int32)
        src = np.zeros(b, np.int32)
        dst = np.zeros(b, np.int32)
        weight = np.zeros(b, np.float32)
        valid = np.zeros(b, bool)
        dirty_v = np.full(b, v, np.int32)
        touched_src = np.full(b, v, np.int32)
        ell_row = np.full(b, v, np.int32)
        ell_col = np.zeros(b, np.int32)
        ell_nbr = np.zeros(b, np.int32)
        ell_wv = np.zeros(b, np.float32)
        if shard_writes is not None:
            # coalesced cell writes carry the final contents
            for j, wr in enumerate(shard_writes):
                slot[j], src[j], dst[j] = wr.lin, wr.src, wr.dst
                weight[j], valid[j] = wr.weight, wr.valid
        else:
            # final slot contents come from the already-updated host graph, so
            # a delete+reinsert of one slot inside a chunk coalesces to one row
            slots = np.fromiter(dict.fromkeys(op[1] for op in ops), np.int64)
            n = slots.shape[0]
            slot[:n] = slots
            src[:n], dst[:n] = self.graph.src[slots], self.graph.dst[slots]
            weight[:n], valid[:n] = self.graph.weight[slots], self.graph.valid[slots]
        dirty_v[: len(ops)] = [op[3] for op in ops]
        touched_src[: len(ops)] = [op[2] for op in ops]
        for j, wr in enumerate(ell_writes):
            ell_row[j], ell_col[j] = wr.row, wr.col
            ell_nbr[j], ell_wv[j] = wr.nbr_val, wr.w_val
        fields = (slot, src, dst, weight, valid, dirty_v, touched_src,
                  ell_row, ell_col, ell_nbr, ell_wv)
        return UpdateBatch(*(torch.from_numpy(x).to(self.device) for x in fields))

    # ------------------------------------------------------- query slot pool
    def _clear_slot(self, slot: int) -> None:
        """Empty every per-slot row in place, on every shard: diff stores,
        DroppedVT, repair counts."""
        for st in self.states:
            for store in (st.dstore, st.jstore, st.drop.det):
                if store is not None:
                    store.iters[slot] = ds.IMAX
                    store.vals[slot] = 0.0
                    store.count[slot] = 0
            if st.drop.flt is not None:
                st.drop.flt.bits[slot] = False
            st.repair_counts[slot] = 0

    def register_slot(self, init_row, drop_cfg: dr.DropConfig | None = None,
                      materialize_join: bool | None = None) -> int:
        """Claim a slot for a new query and compute its trace in-engine.

        ``init_row`` is the query's D_0 ([V]); ``drop_cfg`` its selection
        policy (default: the engine's).  One maintenance sweep whose dirty
        mask seeds only the new row initializes the trace; every other
        registered query is scheduled for zero work.  Returns the slot id.
        """
        return self.register_slots([(init_row, drop_cfg, materialize_join)])[0]

    def register_slots(self, requests: list[tuple]) -> list[int]:
        """Batch form of :meth:`register_slot`: one slot per (init_row,
        drop_cfg[, materialize_join]) request, ALL the new traces computed
        in a single maintenance sweep (the per-query dirty mask seeds
        exactly the new rows).  ``materialize_join`` gates the slot's Join
        store on vdc engines (None → materialize).  Every request is
        checked before any slot is touched."""
        requests = [(req[0], req[1], req[2] if len(req) > 2 else None) for req in requests]
        rows = []
        for init_row, drop_cfg, _jm in requests:
            if drop_cfg is not None:
                dr.params_row(drop_cfg)  # an unknown selection raises here
                if drop_cfg.enabled() and drop_cfg.mode != self.cfg.drop.mode:
                    raise ValueError(
                        f"plan drop mode {drop_cfg.mode!r} does not match the engine's "
                        f"DroppedVT representation {self.cfg.drop.mode!r}"
                    )
            row = torch.as_tensor(init_row, dtype=torch.float32).to(self.device)
            if tuple(row.shape) != (self.cfg.num_vertices,):
                raise ValueError(f"init row shape {tuple(row.shape)} != ({self.cfg.num_vertices},)")
            rows.append(row)
        while len(self._free_slots) < len(requests):
            self._grow_queries()
        slots = []
        for row, (_r, drop_cfg, join_flag) in zip(rows, requests):
            slot = self._free_slots.pop()
            self._clear_slot(slot)
            for k, st in enumerate(self.states):
                block = row[self._block(k)].to(st.init.device)
                st.init[slot] = block
                st.cur[slot] = block
                st.active[slot] = True
                if st.join_mat is not None:
                    st.join_mat[slot] = True if join_flag is None else bool(join_flag)
                if st.drop.params is not None:
                    cfg = drop_cfg if drop_cfg is not None else self.cfg.drop
                    params = dr.set_params_row(st.drop.params, slot, cfg)
                    self.states[k] = st._replace(drop=st.drop._replace(params=params))
            slots.append(slot)
        dirty = np.zeros((self.cfg.num_queries, self.cfg.num_vertices), bool)
        dirty[slots] = True
        self._run_counted(dirty)
        return slots

    def deregister_slot(self, slot: int) -> int:
        """Retire a query slot: empty its rows, free the slot.  Returns the
        accounted bytes released (its D/J/DroppedVT rows and, with dropping
        on, its fixed Bloom and params rows)."""
        if not bool(self.states[0].active[slot]):
            raise ValueError(f"slot {slot} is not active")
        freed = self.slot_nbytes(slot)
        self._clear_slot(slot)
        horizons = []
        for k, st in enumerate(self.states):
            st.init[slot] = self.cfg.semiring.identity
            st.cur[slot] = self.cfg.semiring.identity
            st.active[slot] = False
            if st.join_mat is not None:  # freed slots rejoin the pool materialized
                st.join_mat[slot] = True
            drop = st.drop
            if drop.params is not None:
                drop = drop._replace(params=dr.set_params_row(drop.params, slot, dr.DropConfig()))
            if drop.det is not None:
                horizons.append(stored_horizon(drop.det))
            self.states[k] = st._replace(drop=drop)
        if horizons:
            # re-anchor the dropped-VT horizon on the surviving rows of every
            # shard, so a retired heavy-drop query stops lengthening later
            # sweeps (a Bloom filter cannot delete, so prob keeps its anchor)
            for k, m in enumerate(mesh_lib.pmax(horizons, self.devices)):
                self.states[k] = self.states[k]._replace(drop=self.states[k].drop._replace(max_iter=m))
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return freed

    def slot_nbytes(self, slot: int) -> int:
        """Accounted bytes held by one query slot: its D/J rows, its Det
        records, and (live, with dropping on) its packed Bloom row and
        params row — the live slots sum to :meth:`nbytes`."""
        parts = []
        for st in self.states:
            parts.append(st.dstore.count[slot].sum(dtype=torch.int64) * 8)
            if st.jstore is not None:
                parts.append(st.jstore.count[slot].sum(dtype=torch.int64) * 8)
            if st.drop.det is not None:
                parts.append(st.drop.det.count[slot].sum(dtype=torch.int64) * 4)
        parts.append(self.states[0].active[slot].to(torch.int64))
        host = torch.stack([p.to(self.device) for p in parts]).tolist()  # one transfer
        live = bool(host.pop())
        return int(sum(host)) + (self._fixed_slot_bytes() if live else 0)

    def _fixed_slot_bytes(self) -> int:
        """Bytes every live slot holds whatever it stores: its packed Bloom
        row and its selection row (dropping on only)."""
        fixed = 0
        drop = self.states[0].drop
        if self.cfg.drop.enabled():
            if drop.flt is not None:
                fixed += (drop.flt.num_bits + 7) // 8
            if drop.params is not None:
                fixed += dr.PARAMS_ROW_NBYTES
        return fixed

    @property
    def slot_capacity(self) -> int:
        return self.cfg.num_queries

    def _grow_queries(self) -> None:
        """Double the slot pool.  Every [Q, ...] leaf pads along the query
        axis: stores empty, init/cur the semiring identity, new slots
        inactive and on the free list, Bloom rows clear and selection rows
        from ``dr.make_params(cfg.drop)``.  Shard by shard, the leaves are
        padded one at a time and each old leaf is released before the next
        is padded, so the peak is the new pool plus one old leaf (and the
        replicated leaves the shards of one device share, padded once)."""
        old_q = self.cfg.num_queries
        new_q = max(1, old_q * 2)
        ident = self.cfg.semiring.identity
        shared: dict[int, tuple[Tensor, Tensor]] = {}  # id(old leaf) → (old, padded)

        def padq(x: Tensor, fill, share: bool = False) -> Tensor:
            hit = shared.get(id(x))
            if hit is not None and hit[0] is x:
                return hit[1]
            out = torch.empty((new_q, *x.shape[1:]), dtype=x.dtype, device=x.device)
            out[:old_q] = x
            out[old_q:] = fill
            if share:
                shared[id(x)] = (x, out)
            return out

        for k in range(self.num_shards):
            st = self.states[k]
            stores = {key: None if x is None else list(x) for key, x in
                      (("dstore", st.dstore), ("jstore", st.jstore), ("det", st.drop.det))}
            leaves = {"init": st.init, "cur": st.cur, "repair_counts": st.repair_counts,
                      "active": st.active, "join_mat": st.join_mat,
                      "bits": None if st.drop.flt is None else st.drop.flt.bits}
            # the DroppedVT's scalars and selection rows; its big leaves are above
            drop = st.drop._replace(det=None, flt=None)
            num_hashes = None if st.drop.flt is None else st.drop.flt.num_hashes
            join_mat_none = st.join_mat is None
            del st
            self.states[k] = None  # the lists above hold the shard's only references now
            for parts in stores.values():
                if parts is not None:
                    for j, fill in enumerate((ds.IMAX, 0.0, 0)):
                        parts[j] = padq(parts[j], fill)
            fills = {"init": ident, "cur": ident, "repair_counts": 0, "active": False,
                     "join_mat": True, "bits": False}
            for key, fill in fills.items():
                if leaves[key] is not None:
                    leaves[key] = padq(leaves.pop(key), fill, share=key in ("active", "join_mat", "bits"))
            flt = None if num_hashes is None else bloom_lib.BloomFilter(leaves["bits"], num_hashes)
            params = drop.params
            if params is not None:
                fresh = dr.make_params(self.cfg.drop, new_q - old_q, device=params.p.device)
                params = dr.DropParams(*(torch.cat([a, b]) for a, b in zip(params, fresh)))
            det = None if stores["det"] is None else ds.DiffStore(*stores["det"])
            self.states[k] = EngineState(
                dstore=ds.DiffStore(*stores["dstore"]),
                jstore=None if stores["jstore"] is None else ds.DiffStore(*stores["jstore"]),
                drop=drop._replace(det=det, flt=flt, params=params),
                init=leaves["init"],
                cur=leaves["cur"],
                repair_counts=leaves["repair_counts"],
                active=leaves["active"],
                join_mat=None if join_mat_none else leaves["join_mat"],
            )
        self.cfg = dataclasses.replace(self.cfg, num_queries=new_q)
        self._free_slots.extend(range(new_q - 1, old_q - 1, -1))

    # ------------------------------------------------------------------- api
    def answers(self) -> np.ndarray:
        """Every slot's final vertex states (a host copy). [Q, V]"""
        return torch.cat([st.cur.cpu() for st in self.states], dim=1).numpy()

    def answers_row(self, slot: int) -> np.ndarray:
        """One query slot's final vertex states (a copy). [V]"""
        return torch.cat([st.cur[slot].cpu() for st in self.states]).numpy()

    def answer_rows(self, slots: list[int]) -> Tensor:
        """The answer rows of ``slots`` as one ``[n, V]`` tensor on the
        engine's (first) device."""
        rows = []
        for st in self.states:
            idx = torch.tensor(slots, dtype=torch.int64, device=st.cur.device)
            rows.append(st.cur.index_select(0, idx).to(self.device))
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)

    def nbytes(self) -> int:
        return sum(self.nbytes_per_device())

    def nbytes_per_device(self) -> list[int]:
        """Accounted bytes per shard of the vertex partition (unsharded: one
        entry, the whole store): diff-store and Det rows count with their
        owning vertex block, VDC's J rows with their owning cell block; the
        replicated Bloom and selection rows count once, spread evenly over
        the shards (the remainder on shard 0), so the entries sum to
        :meth:`nbytes` in every drop mode."""
        per = []
        for st in self.states:
            x = st.dstore.count.sum(dtype=torch.int64) * 8
            if st.jstore is not None:
                x = x + st.jstore.count.sum(dtype=torch.int64) * 8
            if st.drop.det is not None:
                x = x + st.drop.det.count.sum(dtype=torch.int64) * 4
            per.append(x.to(self.device))
        per.append(self.states[0].active.sum(dtype=torch.int64))
        host = torch.stack(per).tolist()  # one transfer
        live = host.pop()
        replicated = live * self._fixed_slot_bytes()
        n = self.num_shards
        out = [int(b) + replicated // n for b in host]
        out[0] += replicated - (replicated // n) * n
        return out

    def active_slots(self) -> list[int]:
        return torch.nonzero(self.states[0].active).flatten().tolist()

    def _slot_bytes(self) -> tuple[np.ndarray, np.ndarray | None, list[int]]:
        """Per slot, the Iterate operator's bytes that vary by slot (its
        change points and Det records), its J-store bytes (vdc, else None),
        and the live slots: reduced on the device, one transfer."""
        per = per_j = None
        for st in self.states:
            x = st.dstore.count.sum(dim=1, dtype=torch.int64) * 8
            if st.drop.det is not None:
                x = x + st.drop.det.count.sum(dim=1, dtype=torch.int64) * 4
            x = x.to(self.device)
            per = x if per is None else per + x
            if st.jstore is not None:
                j = (st.jstore.count.sum(dim=1, dtype=torch.int64) * 8).to(self.device)
                per_j = j if per_j is None else per_j + j
        rows = [per, self.states[0].active.to(torch.int64)]
        if per_j is not None:
            rows.append(per_j)
        host = torch.stack(rows).cpu().numpy()
        live = np.nonzero(host[1])[0].tolist()
        return host[0], (host[2] if per_j is not None else None), live

    def nbytes_per_query(self) -> dict[int, int]:
        """slot → accounted bytes, for every live slot; they sum to
        :meth:`nbytes`."""
        per, per_j, live = self._slot_bytes()
        if per_j is not None:
            per = per + per_j
        fixed = self._fixed_slot_bytes()
        return {s: int(per[s]) + fixed for s in live}

    def nbytes_per_operator(self) -> dict[int, dict[str, int]]:
        """slot → {op_id → accounted bytes}: ``"iterate"`` carries the
        change-point rows plus the slot's DroppedVT/params footprint,
        ``"join"`` (vdc) its J-store rows.  Per slot they sum to
        :meth:`nbytes_per_query`'s entry."""
        per_d, per_j, live = self._slot_bytes()
        fixed = self._fixed_slot_bytes()
        out: dict[int, dict[str, int]] = {}
        for s in live:
            ops = {"iterate": int(per_d[s]) + fixed}
            if per_j is not None:
                ops["join"] = int(per_j[s])
            out[s] = ops
        return out

    def _repairs_per_slot(self) -> tuple[np.ndarray, list[int]]:
        """Per slot, the cumulative repair count, and the live slots (one
        transfer)."""
        per = sum(st.repair_counts.sum(dim=1, dtype=torch.int64).to(self.device) for st in self.states)
        host = torch.stack([per, self.states[0].active.to(torch.int64)]).cpu().numpy()
        return host[0], np.nonzero(host[1])[0].tolist()

    def recompute_cost_per_query(self) -> dict[int, int]:
        """slot → cumulative dropped-diff repair count."""
        per, live = self._repairs_per_slot()
        return {s: int(per[s]) for s in live}

    def recompute_cost_per_operator(self) -> dict[int, dict[str, int]]:
        """slot → {op_id → cumulative recompute cost}: ``"iterate"`` is the
        slot's repair count; ``"join"`` (vdc) the cumulative scheduled
        vertex-rerun volume shared evenly across live slots."""
        per, live = self._repairs_per_slot()
        share = self._sched_total // max(len(live), 1)
        out: dict[int, dict[str, int]] = {}
        for s in live:
            ops = {"iterate": int(per[s])}
            if self.states[0].jstore is not None:
                ops["join"] = int(share)
            out[s] = ops
        return out

    def set_join_store(self, slot: int, materialize: bool) -> int:
        """Flip one slot's Join-operator storage policy (vdc engines).

        ``materialize=False`` drops the slot's join differences completely
        (§4): its J rows are emptied and the accounted bytes released are
        returned; later sweeps recompute its messages on demand.
        ``materialize=True`` resets the slot's ``cur`` to D_0 and runs one
        sweep for that slot, which re-walks the stored trajectory and
        rewrites its J rows; returns 0.  The J store is rebuilt, not
        written in place, so earlier states stay as they were.
        """
        st0 = self.states[0]
        if not bool(st0.active[slot]):
            raise ValueError(f"slot {slot} is not active")
        if st0.jstore is None:
            if materialize:
                raise ValueError(
                    "engine built without a join store (mode='jod'); build it with a "
                    "join-materializing plan"
                )
            return 0  # JOD engines hold no join differences to begin with
        if materialize == bool(st0.join_mat[slot]):
            return 0
        freed = 0
        for k, st in enumerate(self.states):
            join_mat = st.join_mat.clone()
            join_mat[slot] = materialize
            if not materialize:
                freed += int(st.jstore.count[slot].sum()) * 8
                iters, vals, count = (x.clone() for x in st.jstore)
                iters[slot], vals[slot], count[slot] = ds.IMAX, 0.0, 0
                self.states[k] = st._replace(jstore=ds.DiffStore(iters, vals, count), join_mat=join_mat)
            else:
                cur = st.cur.clone()
                cur[slot] = st.init[slot]
                self.states[k] = st._replace(cur=cur, join_mat=join_mat)
        if not materialize:
            return freed
        dirty = np.zeros((self.cfg.num_queries, self.cfg.num_vertices), bool)
        dirty[slot] = True
        self._run_counted(dirty)
        return 0

    def set_drop_params(self, slot: int, drop_cfg: dr.DropConfig, op_id: str = "iterate") -> int:
        """Rewrite a LIVE slot's drop policy for ONE operator.

        ``op_id="iterate"`` (default) rewrites the slot's §5 selection row
        and sheds its stored diffs under the new policy (:func:`shed_slot`,
        on every shard).  ``op_id="join"`` routes to :meth:`set_join_store`:
        an enabled config (complete dropping) drops the slot's join trace,
        a disabled one re-materializes it.  Returns the accounted bytes
        released (≥ 0 for iterate: a shed trades 8 B change points for ≤ 4 B
        DroppedVT records or Bloom bits).
        """
        if op_id == "join":
            if drop_cfg.enabled() and not drop_cfg.drops_all():
                raise ValueError(
                    "the join's differences drop completely (p ≥ 1); "
                    "partial join dropping is unsupported"
                )
            return self.set_join_store(slot, not drop_cfg.enabled())
        if op_id != "iterate":
            raise ValueError(f"operator {op_id!r} owns no engine difference store")
        st0 = self.states[0]
        if not bool(st0.active[slot]):
            raise ValueError(f"slot {slot} is not active")
        if st0.drop.params is None:
            if drop_cfg.enabled():
                raise ValueError(
                    "cannot enable dropping on an engine built without a "
                    "DroppedVT representation (cfg.drop.mode='none')"
                )
            return 0
        if drop_cfg.enabled() and drop_cfg.mode != self.cfg.drop.mode:
            raise ValueError(
                f"drop mode {drop_cfg.mode!r} does not match the engine's "
                f"DroppedVT representation {self.cfg.drop.mode!r}"
            )
        before = self.slot_nbytes(slot)
        for k, st in enumerate(self.states):
            params = dr.set_params_row(st.drop.params, slot, drop_cfg)
            self.states[k] = st._replace(drop=st.drop._replace(params=params))
        if drop_cfg.enabled():
            ovf_before = int(self.states[0].drop.det_overflow)
            self._shed(slot)
            self.det_overflow_shed += int(self.states[0].drop.det_overflow) - ovf_before
        return before - self.slot_nbytes(slot)

    def _shed(self, slot: int) -> None:
        """:func:`shed_slot` on every shard, then the replicated DroppedVT
        merged: evictions summed, ``max_iter`` maxed, the Bloom bits OR-ed
        where the shards hold distinct copies."""
        old = self.states
        shed = [shed_slot(self.cfg, st, g, slot, self._block(k).start)
                for k, (st, g) in enumerate(zip(old, self.gs))]
        grown = mesh_lib.psum([s.drop.det_overflow - o.drop.det_overflow for s, o in zip(shed, old)],
                              self.devices)
        max_iter = mesh_lib.pmax([s.drop.max_iter for s in shed], self.devices)
        shed = [s._replace(drop=s.drop._replace(det_overflow=o.drop.det_overflow + g_, max_iter=m))
                for s, o, g_, m in zip(shed, old, grown, max_iter)]
        self.states = shed
        bits = [st.drop.flt.bits for st in shed if st.drop.flt is not None]
        if len({b.data_ptr() for b in bits}) > 1:
            # each device's copy took its own shards' inserts in place: OR them
            for b, merged in zip(bits, mesh_lib.por(bits, self.devices)):
                if b is not merged:
                    b.copy_(merged)

    # ------------------------------------------------------------ durability
    def export_state(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) snapshot of the difference trace, host copies.

        The keys, dtypes and ``meta`` are the reference's, so a snapshot of
        either package imports into the other: stores as
        ``"{dstore,jstore,drop_det}/{iters,vals,count}"`` (the J store in
        the canonical edge-slot layout ``[Q, E_cap, S_J]``, whatever the
        mesh), ``"drop_flt/bits"``, ``"drop/det_overflow"``,
        ``"drop/max_iter"``, ``"drop_params/<field>"`` (the seed as
        uint32), ``init``, ``cur``, ``repair_counts``, ``active`` and
        ``join_mat``.  The arrays are global, so a snapshot taken at any
        shard count restores at any other (:meth:`import_state`).
        """
        st = self.state if not self.sharded else self._global_state(torch.device("cpu"))  # J: edge slots
        arrays: dict[str, np.ndarray] = {}

        def put_store(prefix: str, store: ds.DiffStore) -> None:
            for k in ("iters", "vals", "count"):
                arrays[f"{prefix}/{k}"] = _host_copy(getattr(store, k))

        put_store("dstore", st.dstore)
        if st.jstore is not None:
            put_store("jstore", st.jstore)
        drop = st.drop
        if drop.det is not None:
            put_store("drop_det", drop.det)
        if drop.flt is not None:
            arrays["drop_flt/bits"] = _host_copy(drop.flt.bits)
        arrays["drop/det_overflow"] = _host_copy(drop.det_overflow)
        arrays["drop/max_iter"] = _host_copy(drop.max_iter)
        if drop.params is not None:
            for f in dr.DropParams._fields:
                x = _host_copy(getattr(drop.params, f))
                arrays[f"drop_params/{f}"] = x.astype(np.uint32) if f == "seed" else x
        for k in ("init", "cur", "repair_counts", "active"):
            arrays[k] = _host_copy(getattr(st, k))
        if st.join_mat is not None:
            arrays["join_mat"] = _host_copy(st.join_mat)
        meta = {
            "slot_capacity": self.cfg.num_queries,
            "mode": self.cfg.mode,
            "free_slots": [int(s) for s in self._free_slots],
            "det_overflow_shed": int(self.det_overflow_shed),
            "sched_total": int(self._sched_total),
            "ell_width": int(self._ell_width),
        }
        return arrays, meta

    def import_state(self, arrays: dict, meta: dict) -> None:
        """Load a snapshot produced by :meth:`export_state` (of this package
        or the reference, at any shard count).  The engine must have been
        built for the same graph and slot capacity (an all-inactive pool
        skips the initial sweep, so building one is cheap); a sharded engine
        scatters the J store into its own cell layout and places every leaf
        on its shards."""
        if int(meta["slot_capacity"]) != self.cfg.num_queries:
            raise ValueError(
                f"checkpoint has {meta['slot_capacity']} query slots but the "
                f"engine was built with {self.cfg.num_queries}"
            )
        dev = self.device if not self.sharded else torch.device("cpu")  # sharded: staged on the host

        def put(x) -> Tensor:
            return torch.from_numpy(np.array(x, copy=True)).to(dev)

        def get_store(prefix: str) -> ds.DiffStore:
            return ds.DiffStore(*(put(arrays[f"{prefix}/{k}"]) for k in ("iters", "vals", "count")))

        flt = params = None
        if "drop_flt/bits" in arrays:
            flt = bloom_lib.BloomFilter(put(arrays["drop_flt/bits"]), self.cfg.drop.bloom_hashes)
        if "drop_params/p" in arrays:
            params = dr.DropParams(*(
                put(np.asarray(arrays[f"drop_params/{f}"]).astype(np.int64) if f == "seed"
                    else arrays[f"drop_params/{f}"])
                for f in dr.DropParams._fields
            ))
        self.state = EngineState(  # sharded: the setter moves J into the cells
            dstore=get_store("dstore"),
            jstore=get_store("jstore") if "jstore/iters" in arrays else None,
            drop=dr.DropState(
                det=get_store("drop_det") if "drop_det/iters" in arrays else None,
                flt=flt,
                det_overflow=put(arrays["drop/det_overflow"]),
                max_iter=put(arrays["drop/max_iter"]),
                params=params,
            ),
            init=put(arrays["init"]),
            cur=put(arrays["cur"]),
            repair_counts=put(arrays["repair_counts"]),
            active=put(arrays["active"]),
            join_mat=put(arrays["join_mat"]) if "join_mat" in arrays else None,
        )
        self._free_slots = [int(s) for s in meta["free_slots"]]
        self.det_overflow_shed = int(meta["det_overflow_shed"])
        self._sched_total = int(meta["sched_total"])
        width = int(meta.get("ell_width", 0))
        if self.cfg.backend in ("ell", "fused") and width > self._ell_width:
            # the saved run had grown its ELL width: match it
            self._ell_width = width
            self.gs = self._device_graphs(self.graph.snapshot())
        self.last_stats = None
