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
geometric regrow) that the session layer (``core/session.py``) drives.  The
vertex-sharded sweep raises :class:`NotImplementedError` until its slice of
the port lands (ROADMAP Queue 1 item 4).

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
:func:`_maintain_core`).  :func:`batched_step` updates the graph arrays in
place, where the reference donates them.  Between sweeps, the slot-pool
edits of :class:`DiffIFE` (register, deregister, :func:`shed_slot`) write
the affected slot's rows of the engine's own state in place, where the
reference builds new arrays (``.at[slot].set``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bloom as bloom_lib
from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.core.graph import DynamicGraph, EllIndex, EllOverflow, GraphSnapshot
from repro_torch.core.semiring import Semiring, reduce_pair
from repro_torch.kernels.diff_lookup import diff_lookup
from repro_torch.kernels.ell_spmv import ell_spmv, transpose_states
from repro_torch.kernels.fused_sweep import fused_sweep
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


def aggregate(cfg: EngineConfig, msgs: Tensor, cur: Tensor, g: GraphArrays) -> Tensor:
    """D_i from J_i (+ carry of D_{i-1}): the Min/Sum operator. [Q, V]

    Empty segments read +inf under min and 0 under sum, as the reference's
    ``segment_min``/``segment_sum`` fill them.  The sum adds each segment
    in one fixed order (the edges sorted by destination, stably): a
    scatter-add's atomics on the card would add in another order on every
    run, so two runs of one stream (VDC's ``coo`` and ``fused``) would part.
    On the CPU the order is the scatter-add's own, edge by edge.
    """
    sr = cfg.semiring
    q, v = msgs.shape[0], cfg.num_vertices
    if sr.reduce == "min":
        agg = torch.full((q, v), float("inf"), dtype=msgs.dtype, device=msgs.device)
        idx = g.dst.long()[None, :].expand(q, -1)
        agg.scatter_reduce_(1, idx, msgs, "amin", include_self=True)
    else:
        order = torch.sort(g.dst, stable=True).indices
        lengths = torch.bincount(g.dst, minlength=v).expand(q, -1).contiguous()
        agg = torch.segment_reduce(msgs.index_select(1, order), "sum", lengths=lengths, axis=1,
                                   unsafe=True)
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


def _ell_operands(cfg: EngineConfig, cur: Tensor, g: GraphArrays) -> dict:
    """The expand's operands for the ELL and fused kernels: the states
    transposed, ``[V+1, Q]`` with the identity in the sentinel row V that
    padding cells point at (built in one pass, as the kernels read them),
    the weight tile and the carry."""
    sr = cfg.semiring
    return dict(
        states=transpose_states(cur, sr.identity),
        transposed=True,
        nbr=g.nbr,
        w=_ell_weights(cfg, g),
        kcarry=cur if sr.carry_prev else torch.full_like(cur, sr.base),
    )


def ell_step(cfg: EngineConfig, cur: Tensor, g: GraphArrays) -> Tensor:
    """One exact IFE step through the ELL SpMV kernel (JOD fused)."""
    ops = _ell_operands(cfg, cur, g)
    sr = cfg.semiring
    return ell_spmv(
        ops["states"], ops["nbr"], ops["w"], ops["kcarry"],
        semiring=sr.kernel_name, hop_cap=sr.hop_cap, transposed=True,
    )


def ife_step(cfg: EngineConfig, cur: Tensor, g: GraphArrays) -> Tensor:
    """One exact IFE step D_{i-1} → D_i (join recomputed — the JOD path).
    Under ``fused`` it is the ELL step (the scratch oracle reuses it)."""
    if cfg.backend in ("ell", "fused"):
        return ell_step(cfg, cur, g)
    return aggregate(cfg, edge_messages(cfg, cur, g), cur, g)


def push_frontier(changed: Tensor, g: GraphArrays) -> Tensor:
    """Out-neighbour mask of changed vertices (δD direct rule).

    The reference takes a ``segment_max`` of the per-edge hits over ``dst``;
    an OR needs no reduction, so the (few) hit edges set their destination
    directly — a scatter-add over every ``[Q, E]`` cell costs far more on
    the card (see PERF.md).
    """
    hit = changed.index_select(1, g.src) & g.valid[None, :]
    q_idx, e_idx = hit.nonzero(as_tuple=True)
    out = torch.zeros(changed.shape, dtype=torch.bool, device=changed.device)
    out[q_idx, g.dst[e_idx].long()] = True
    return out


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
    i: int  # the iteration this body computes (host loop counter)
    cur: Tensor  # exact D_{i-1}
    cur_old: Tensor  # pre-update trajectory value at i-1 (store-lookup based)
    stale_old: Tensor  # bool [Q,V]: old trajectory obscured by a dropped diff
    frontier: Tensor  # bool [Q,V]: δD direct-rule schedule for iteration i
    changed_prev: Tensor  # bool [Q,V]: changed at i-1, or (VDC) scheduled there (feeds the J updates)
    dstore: ds.DiffStore
    jstore: ds.DiffStore | None  # the sweep's own clone, updated in place (vdc)
    drop: dr.DropState
    repair_counts: Tensor  # int32 [Q,V]
    horizon: Tensor  # int32 — running max change-point iteration (upper bound)
    live: Tensor  # bool — work remains (frontier ∪ dirty nonempty)
    stats: MaintainStats
    owned: bool  # dstore (and the Det store) are the sweep's own buffers, not its input's


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


def _degree(g: GraphArrays) -> Tensor:
    """Total degree per vertex (f32 [V]), the Degree selection's input."""
    return (g.out_degree + g.in_degree).to(torch.float32)


def _stitched_step(
    cfg: EngineConfig,
    g: GraphArrays,
    sched: Tensor,
    old_dstore: ds.DiffStore,
    active: Tensor,
    c: _Carry,
    new: Tensor | None,
) -> _Step:
    """One iteration as separate tensor passes around the aggregator
    (``new``: VDC's candidate from the J store; None runs the JOD step)."""
    i = c.i
    q, v = c.cur.shape
    drop_on = cfg.drop.enabled()
    if new is None:
        new = ife_step(cfg, c.cur, g)

    # dropped change points at i must be recomputed to keep `cur` exact
    # (AccessDᵢᵛWithDrops, forward form); Prob-Drop may false-positive here
    # → spurious but safe recompute
    dropped_here = dr.dropped_at(c.drop, i, v) if drop_on else torch.zeros_like(sched)
    repair = dropped_here & active[:, None] & ~sched

    # pre-update trajectory at i (δ detection), from the frozen store; a
    # dropped old change point leaves old_i stale until the next stored old
    # point re-anchors it
    old_has, old_val = ds.value_at(old_dstore, i)
    old_i = torch.where(old_has, old_val, c.cur_old)
    stale = (c.stale_old | dropped_here) & ~old_has
    changed = sched & ((new != old_i) | stale)

    # new trajectory change point at i?  (vs exact D_{i-1} = cur)
    want_point = sched & (new != c.cur)
    has_cur, cur_stored_val = ds.value_at(c.dstore, i)
    if drop_on:
        q_ids = torch.arange(q, dtype=torch.int32, device=sched.device)[:, None]
        v_ids = torch.arange(v, dtype=torch.int32, device=sched.device)[None, :]
        picked = dr.select_to_drop(c.drop.params, _degree(g)[None, :], q_ids, v_ids, i)
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
    if drop_on:
        drop = dr.register(drop, i, to_drop)
        drop = dr.register(drop, evicted_iter, evicted)
        # a dropped record is stale once the point is stored or vanished
        drop = dr.unregister(drop, i, to_store | vanish)

    cur_next = torch.where(sched | repair, new, torch.where(has_cur, cur_stored_val, c.cur))
    return _Step(dstore, drop, cur_next, old_i, stale, changed, repair, to_store, to_drop, vanish)


def _fused_step(
    cfg: EngineConfig,
    g: GraphArrays,
    sched: Tensor,
    old_dstore: ds.DiffStore,
    active: Tensor,
    c: _Carry,
    new: Tensor | None,
) -> _Step:
    """One iteration in one ``fused_sweep`` launch; Det rows come back from
    the kernel, Bloom inserts run here (the OR is idempotent, so the bits
    equal the stitched path's).  VDC passes its candidate as ``new=``; JOD
    runs the expand in the kernel.

    The first iteration writes fresh stores (its working store is the
    frozen input state's); every later one updates the sweep's own D and
    Det stores in place, where the reference returns new arrays."""
    sr, mode = cfg.semiring, cfg.drop.mode
    kw: dict = _ell_operands(cfg, c.cur, g) if new is None else {"new": new}
    if cfg.drop.enabled():
        kw.update(degree=_degree(g), params=c.drop.params)
        if mode == "det":
            kw["det"] = c.drop.det
        else:
            kw.update(bloom_bits=c.drop.flt.bits, bloom_hashes=c.drop.flt.num_hashes)
    out = fused_sweep(
        c.i, sched, active, c.cur, c.cur_old, c.stale_old, c.dstore, old_dstore,
        semiring=sr.kernel_name, hop_cap=sr.hop_cap, drop_mode=mode, inplace=c.owned, **kw,
    )
    drop = c.drop
    if mode == "det":
        drop = drop._replace(
            det=ds.DiffStore(out.det_iters, c.drop.det.vals, out.det_count),
            det_overflow=c.drop.det_overflow + out.det_overflow.sum(dtype=torch.int32),
            max_iter=torch.maximum(c.drop.max_iter, out.det_max_iter.max()),
        )
    elif mode == "prob":
        drop = dr.register(drop, c.i, out.to_drop)
        drop = dr.register(drop, out.evicted_iter, out.evicted)
    return _Step(
        ds.DiffStore(out.d_iters, out.d_vals, out.d_count), drop, out.cur, out.old,
        out.stale, out.changed, out.repair, out.to_store, out.to_drop, out.vanish,
    )


def _j_messages(jstore: ds.DiffStore, i: int, j0: Tensor) -> Tensor:
    """The J store's messages at iteration i: the latest stored change point
    ≤ i per (q, edge) through the ``diff_lookup`` kernel on the flattened
    ``[Q·E_cap, S_J]`` rows, else the implicit J from D_0. [Q, E]"""
    q, e, s = jstore.iters.shape
    val, _, found = diff_lookup(jstore.iters.view(q * e, s), jstore.vals.view(q * e, s), i)
    return torch.where(found.view(q, e), val.view(q, e), j0)


def _vdc_candidate(
    cfg: EngineConfig,
    g: GraphArrays,
    dirty_pad: Tensor,
    j0: Tensor,
    join_mat: Tensor,
    c: _Carry,
) -> tuple[Tensor, Tensor]:
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
    overwritten with the identity.  Returns (candidate, rows written).
    """
    i = c.i
    live_msgs = edge_messages(cfg, c.cur, g)
    jprev = _j_messages(c.jstore, i, j0)
    jmat = join_mat[:, None]
    jdirty = c.changed_prev.index_select(1, g.src) | dirty_pad.index_select(1, g.dst)
    jwrite = jdirty & (live_msgs != jprev) & jmat
    ds.upsert_rows_(c.jstore, i, jwrite, live_msgs)
    msgs = torch.where(jmat, _j_messages(c.jstore, i, j0), live_msgs)
    return aggregate(cfg, msgs, c.cur, g), _count(jwrite)


def _sweep_body(
    cfg: EngineConfig,
    g: GraphArrays,
    dirty: Tensor,
    dirty_pad: Tensor | None,
    j0: Tensor | None,
    old_dstore: ds.DiffStore,
    state: EngineState,
    c: _Carry,
) -> _Carry:
    """One IFE iteration of the sweep, stitched or fused (VDC: after the
    J maintenance of :func:`_vdc_candidate`)."""
    i = c.i
    active = state.active
    # δE direct + upper-bound rules: dirty endpoints rerun at every live i
    sched = (c.frontier | dirty) & active[:, None]
    new, jwritten = None, c.stats.jwritten
    if cfg.mode == "vdc":
        new, n_jwrite = _vdc_candidate(cfg, g, dirty_pad, j0, state.join_mat, c)
        jwritten = jwritten + n_jwrite
    step = (_fused_step if cfg.backend == "fused" else _stitched_step)(
        cfg, g, sched, old_dstore, active, c, new
    )
    # | changed: carry a changed vertex's own next value
    frontier_next = push_frontier(step.changed, g) | step.changed

    # per-iteration probe: iteration i lands in bin i-1 (clamped to the last bin)
    bin_i = min(i - 1, ITER_TRACE - 1)
    n_sched = _count(sched)
    sched_sizes = c.stats.sched_sizes.clone()
    sched_sizes[bin_i] += n_sched
    frontier_sizes = c.stats.frontier_sizes.clone()
    frontier_sizes[bin_i] += _count(frontier_next)
    stats = c.stats._replace(
        iters_run=c.stats.iters_run + 1,
        scheduled=c.stats.scheduled + n_sched,
        changed=c.stats.changed + _count(step.changed),
        repairs=c.stats.repairs + _count(step.repair),
        written=c.stats.written + _count(step.to_store),
        removed=c.stats.removed + _count(step.vanish),
        dropped=c.stats.dropped + _count(step.to_drop),
        jwritten=jwritten,
        sched_sizes=sched_sizes,
        frontier_sizes=frontier_sizes,
    )
    horizon = torch.where(step.to_store.any(), c.horizon.clamp(min=i), c.horizon)
    return _Carry(
        i=i + 1,
        cur=step.cur,
        cur_old=step.old,
        stale_old=step.stale,
        frontier=frontier_next,
        # VDC: a vertex rescheduled at i may have reverted to its old value
        # without reading as changed; its out-edges' stored messages must be
        # re-checked at i+1 all the same, or a stale J row outlives it
        changed_prev=(step.changed | sched) if cfg.mode == "vdc" else step.changed,
        dstore=step.dstore,
        jstore=c.jstore,
        drop=step.drop,
        repair_counts=c.repair_counts + step.repair.to(torch.int32),
        horizon=horizon,
        live=frontier_next.any() | dirty.any(),
        stats=stats,
        owned=True,  # every step returns new stores or updates owned ones
    )


def _maintain_core(
    cfg: EngineConfig, state: EngineState, g: GraphArrays, dirty: Tensor
) -> tuple[EngineState, MaintainStats]:
    """The maintenance loop.  ``dirty`` is the per-query [Q, V] schedule seed.

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
    old_dstore = state.dstore  # frozen: the sweep writes only into its own stores
    zeros = torch.zeros(dirty.shape, dtype=torch.bool, device=dirty.device)
    jstore = dirty_pad = j0 = None
    if cfg.mode == "vdc":
        jstore = ds.DiffStore(*(x.clone() for x in state.jstore))
        pad = torch.zeros((dirty.shape[0], 1), dtype=torch.bool, device=dirty.device)
        dirty_pad = torch.cat([dirty, pad], dim=1)
        j0 = edge_messages(cfg, state.init, g)  # implicit J from D_0
    c = _Carry(
        i=1,
        cur=state.init,
        cur_old=state.init,
        stale_old=zeros,
        frontier=zeros,
        changed_prev=zeros,
        dstore=state.dstore,
        jstore=jstore,
        drop=state.drop,
        repair_counts=state.repair_counts,
        horizon=stored_horizon(state.dstore),
        live=dirty.any(),
        stats=zeros_stats(dirty.device),
        owned=False,
    )
    while c.i <= cfg.max_iters:
        # the one host sync of an iteration: all loop scalars at once
        live, horizon, max_iter = torch.stack(
            [c.live.to(torch.int32), c.horizon, c.drop.max_iter]
        ).tolist()
        if not (live and (c.i == 1 or c.i <= max(horizon, max_iter) + 1)):
            break
        c = _sweep_body(cfg, g, dirty, dirty_pad, j0, old_dstore, state, c)
    # Det-Drop record loss this sweep
    stats = c.stats._replace(det_overflow=c.drop.det_overflow - state.drop.det_overflow)
    # a sweep with nothing dirty runs no iteration and changes nothing: its
    # answers stay the last sweep's (the carry's `cur` is still D_0; the
    # reference returns that, ROADMAP Queue 3)
    cur = c.cur if c.i > 1 else state.cur
    new_state = state._replace(
        dstore=c.dstore, jstore=c.jstore, drop=c.drop, cur=cur, repair_counts=c.repair_counts
    )
    return new_state, stats


def _dirty_2d(cfg: EngineConfig, dirty: Tensor) -> Tensor:
    """Normalize a [V] vertex mask to the per-query [Q, V] schedule seed."""
    dirty = dirty.to(torch.bool)
    if dirty.ndim == 1:
        dirty = dirty[None, :].expand(cfg.num_queries, -1)
    return dirty


def maintain(
    cfg: EngineConfig, state: EngineState, g: GraphArrays, dirty: Tensor
) -> tuple[EngineState, MaintainStats]:
    """One maintenance sweep after a δE batch (or initial computation).

    ``dirty`` is the bool mask of vertices whose in-edge set (or, for
    degree-derived weights, whose incoming message weights) changed — [V]
    (broadcast to every query) or [Q, V].  For the initial computation pass
    ``dirty = ones`` with an empty store — the sweep then *is* the static IFE
    run, recording change points as it goes.
    """
    return _maintain_core(cfg, state, g, _dirty_2d(cfg, dirty))


def shed_slot(cfg: EngineConfig, state: EngineState, g: GraphArrays, slot: int) -> EngineState:
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
    columns with nothing to shed are skipped (one host sync).
    """
    drop = state.drop
    if drop.params is None or not bool(state.active[slot]):
        return state
    row = slice(slot, slot + 1)
    iters, vals, count = (x[row] for x in state.dstore)  # views of the slot's rows
    params = dr.DropParams(*(x[row] for x in drop.params))
    mask = dr.select_stored_to_drop(params, _degree(g), iters, ds.IMAX, q_ids=slot)
    sub = dr.DropState(
        det=None if drop.det is None else ds.DiffStore(*(x[row] for x in drop.det)),
        flt=None if drop.flt is None else drop.flt._replace(bits=drop.flt.bits[row]),
        det_overflow=drop.det_overflow,
        max_iter=drop.max_iter,
    )
    for col in mask.any(dim=1)[0].nonzero().flatten().tolist():
        sub = dr.register_(sub, iters[..., col], mask[..., col], q_offset=slot)
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


def answers(cfg: EngineConfig, state: EngineState) -> Tensor:
    """Final vertex states after the last maintenance sweep. [Q, V]"""
    return state.cur


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
    donates them); the engine state is not modified.
    """
    v, e = cfg.num_vertices, g.src.shape[0]
    keep = upd.slot < e  # padding rows (slot == E_cap) scatter nothing
    slot = upd.slot[keep].long()
    src = g.src.index_put_((slot,), upd.src[keep])
    dst = g.dst.index_put_((slot,), upd.dst[keep])
    weight = g.weight.index_put_((slot,), upd.weight[keep])
    valid = g.valid.index_put_((slot,), upd.valid[keep])
    # degrees recomputed from the edge list — immune to host/device drift
    live = valid.to(torch.int32)
    out_degree = torch.zeros(v, dtype=torch.int32, device=live.device).index_add_(0, src, live)
    in_degree = torch.zeros(v, dtype=torch.int32, device=live.device).index_add_(0, dst, live)
    nbr, ell_w = g.nbr, g.ell_w
    if cfg.backend in ("ell", "fused"):
        row_ok = upd.ell_row < v  # padding rows (ell_row == V) write nothing
        cell = (upd.ell_row[row_ok].long(), upd.ell_col[row_ok].long())
        nbr.index_put_(cell, upd.ell_nbr[row_ok])
        ell_w.index_put_(cell, upd.ell_w[row_ok])
    g2 = GraphArrays(src, dst, weight, valid, out_degree, in_degree, nbr, ell_w)

    dirty = _mark(v, upd.dirty_v)
    if cfg.weight_from_degree:
        # outdeg(u) changed → every out-message of u retunes (δE dirty rule)
        hit = (_mark(v, upd.touched_src).index_select(0, src) & valid).to(torch.int32)
        retuned = torch.zeros(v, dtype=torch.int32, device=hit.device).index_add_(0, dst, hit)
        dirty = dirty | (retuned > 0)

    new_state, stats = maintain(cfg, state, g2, dirty)
    return new_state, g2, stats


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

    **Query slot pool**: the leading Q axis is a padded pool of query slots
    gated by ``state.active``.  :meth:`register_slots` claims free slots
    (doubling the pool when none is left) and computes the new queries'
    traces in one maintenance sweep whose per-query dirty mask seeds only
    the new rows; :meth:`deregister_slot` empties a slot's rows and returns
    the accounted bytes freed.  These edits write the slot's rows in place.

    ``device=None`` runs on the CUDA device (and raises without one);
    ``device="cpu"`` runs the plain PyTorch versions.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        graph: DynamicGraph,
        init: np.ndarray | Tensor,
        *,
        batch_capacity: int = 32,
        mesh=None,
        active=None,
        drop_rows: list[dr.DropConfig] | None = None,
        join_rows: list[bool] | None = None,
        device=None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "the vertex-sharded sweep (mesh=) is not ported yet: it comes "
                "with the sharded slice of the port (ROADMAP Queue 1 item 4)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph
        self.batch_capacity = int(batch_capacity)
        self._ell_width = 0
        self._ell_index: EllIndex | None = None
        self.g = self._device_graph(graph.snapshot())
        # a copy: slot edits write rows of the state in place
        init = torch.as_tensor(init, dtype=torch.float32).to(self.device, copy=True)
        self.state = make_state(
            cfg, init, graph.capacity, active=active, drop_rows=drop_rows, join_rows=join_rows
        )
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

    # ------------------------------------------------------------ device views
    def _device_graph(self, snap: GraphSnapshot) -> GraphArrays:
        if self.cfg.backend in ("ell", "fused"):
            g = GraphArrays.from_snapshot(
                snap, backend=self.cfg.backend, ell_min_width=self._ell_width, device=self.device
            )
            self._ell_width = g.ell_width
            self._ell_index = EllIndex(snap, self._ell_width)
            return g
        return GraphArrays.from_snapshot(snap, device=self.device)

    def _run(self, dirty: np.ndarray) -> MaintainStats:
        """One sweep; returns its device-side stats (``last_stats`` gets a
        host copy)."""
        dirty_t = torch.from_numpy(np.asarray(dirty, bool)).to(self.device)
        self.state, stats = maintain(self.cfg, self.state, self.g, dirty_t)
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
        with obs_trace.span("sweep", "sweep", pid="engine:dense", shards=1) as sp:
            ops = self.graph.apply_batch_resolved(updates)
            snap = self.graph.snapshot()
            self.g = self._device_graph(snap)
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
            self.g = self._device_graph(snap)
            touched = [(u, v) for (_k, _s, u, v, _w) in ops]
            stats = self._run(self._dirty_mask(touched, snap))
        return _sum_stats(total, stats)

    def apply_updates_batched(
        self, updates, batch_size: int | None = None
    ) -> MaintainStats:
        """Stream a δE log through :func:`batched_step`.

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
            shards=1,
        ) as outer:
            for lo in range(0, len(updates), b):
                ops = self.graph.apply_batch_resolved(updates[lo : lo + b])
                if not ops:
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
                upd = self._encode_chunk(ops, ell_writes, b)
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
                        self.state, self.g, stats = batched_step(
                            self.cfg, self.state, self.g, upd
                        )
                    total = _sum_stats(total, stats)
            self.last_stats = _stats_to_host(total)
            outer.set(**_span_stats(self.last_stats))
        self._sched_total += int(self.last_stats.scheduled)
        return self.last_stats

    def _encode_chunk(self, ops, ell_writes, b: int) -> UpdateBatch:
        """Host O(B) encode of resolved ops → fixed-shape UpdateBatch."""
        if len(ops) > b:
            raise ValueError(f"chunk of {len(ops)} ops exceeds capacity {b}")
        v = self.cfg.num_vertices
        slot = np.full(b, self.graph.capacity, np.int32)
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
        # final slot contents come from the already-updated host graph, so a
        # delete+reinsert of one slot inside a chunk coalesces to one row
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
        """Empty every per-slot row in place: diff stores, DroppedVT,
        repair counts."""
        st = self.state
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
            st = self.state
            st.init[slot] = row
            st.cur[slot] = row
            st.active[slot] = True
            if st.join_mat is not None:
                st.join_mat[slot] = True if join_flag is None else bool(join_flag)
            if st.drop.params is not None:
                cfg = drop_cfg if drop_cfg is not None else self.cfg.drop
                params = dr.set_params_row(st.drop.params, slot, cfg)
                self.state = st._replace(drop=st.drop._replace(params=params))
            slots.append(slot)
        dirty = np.zeros((self.cfg.num_queries, self.cfg.num_vertices), bool)
        dirty[slots] = True
        self._run_counted(dirty)
        return slots

    def deregister_slot(self, slot: int) -> int:
        """Retire a query slot: empty its rows, free the slot.  Returns the
        accounted bytes released (its D/J/DroppedVT rows and, with dropping
        on, its fixed Bloom and params rows)."""
        if not bool(self.state.active[slot]):
            raise ValueError(f"slot {slot} is not active")
        freed = self.slot_nbytes(slot)
        self._clear_slot(slot)
        st = self.state
        st.init[slot] = self.cfg.semiring.identity
        st.cur[slot] = self.cfg.semiring.identity
        st.active[slot] = False
        if st.join_mat is not None:  # freed slots rejoin the pool materialized
            st.join_mat[slot] = True
        drop = st.drop
        if drop.params is not None:
            drop = drop._replace(params=dr.set_params_row(drop.params, slot, dr.DropConfig()))
        if drop.det is not None:
            # re-anchor the dropped-VT horizon on the surviving rows, so a
            # retired heavy-drop query stops lengthening later sweeps (a
            # Bloom filter cannot delete, so prob keeps its anchor)
            drop = drop._replace(max_iter=stored_horizon(drop.det))
        self.state = st._replace(drop=drop)
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return freed

    def slot_nbytes(self, slot: int) -> int:
        """Accounted bytes held by one query slot: its D/J rows, its Det
        records, and (live, with dropping on) its packed Bloom row and
        params row — the live slots sum to :meth:`nbytes`."""
        st = self.state
        parts = [st.dstore.count[slot].sum(dtype=torch.int64) * 8, st.active[slot].to(torch.int64)]
        if st.jstore is not None:
            parts.append(st.jstore.count[slot].sum(dtype=torch.int64) * 8)
        if st.drop.det is not None:
            parts.append(st.drop.det.count[slot].sum(dtype=torch.int64) * 4)
        host = torch.stack(parts).tolist()  # one transfer
        live = bool(host.pop(1))
        return int(sum(host)) + (self._fixed_slot_bytes() if live else 0)

    def _fixed_slot_bytes(self) -> int:
        """Bytes every live slot holds whatever it stores: its packed Bloom
        row and its selection row (dropping on only)."""
        fixed = 0
        if self.cfg.drop.enabled():
            if self.state.drop.flt is not None:
                fixed += (self.state.drop.flt.num_bits + 7) // 8
            if self.state.drop.params is not None:
                fixed += dr.PARAMS_ROW_NBYTES
        return fixed

    @property
    def slot_capacity(self) -> int:
        return self.cfg.num_queries

    def _grow_queries(self) -> None:
        """Double the slot pool.  Every [Q, ...] leaf pads along the query
        axis: stores empty, init/cur the semiring identity, new slots
        inactive and on the free list, Bloom rows clear and selection rows
        from ``dr.make_params(cfg.drop)``.  The leaves are padded one at a
        time and each old leaf is released before the next is padded, so
        the peak is the new pool plus one old leaf."""
        old_q = self.cfg.num_queries
        new_q = max(1, old_q * 2)
        ident = self.cfg.semiring.identity

        def padq(x: Tensor, fill) -> Tensor:
            out = torch.empty((new_q, *x.shape[1:]), dtype=x.dtype, device=x.device)
            out[:old_q] = x
            out[old_q:] = fill
            return out

        st = self.state
        stores = {k: None if x is None else list(x) for k, x in
                  (("dstore", st.dstore), ("jstore", st.jstore), ("det", st.drop.det))}
        leaves = {"init": st.init, "cur": st.cur, "repair_counts": st.repair_counts,
                  "active": st.active, "join_mat": st.join_mat,
                  "bits": None if st.drop.flt is None else st.drop.flt.bits}
        # the DroppedVT's scalars and selection rows; its big leaves are above
        drop = st.drop._replace(det=None, flt=None)
        num_hashes = None if st.drop.flt is None else st.drop.flt.num_hashes
        join_mat_none = st.join_mat is None
        del st
        self.state = None  # the lists above hold the only references now
        for parts in stores.values():
            if parts is not None:
                for j, fill in enumerate((ds.IMAX, 0.0, 0)):
                    parts[j] = padq(parts[j], fill)
        fills = {"init": ident, "cur": ident, "repair_counts": 0, "active": False,
                 "join_mat": True, "bits": False}
        for k, fill in fills.items():
            if leaves[k] is not None:
                leaves[k] = padq(leaves.pop(k), fill)
        flt = None if num_hashes is None else bloom_lib.BloomFilter(leaves["bits"], num_hashes)
        params = drop.params
        if params is not None:
            fresh = dr.make_params(self.cfg.drop, new_q - old_q, device=self.device)
            params = dr.DropParams(*(torch.cat([a, b]) for a, b in zip(params, fresh)))
        det = None if stores["det"] is None else ds.DiffStore(*stores["det"])
        self.state = EngineState(
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
        return answers(self.cfg, self.state).cpu().numpy()

    def answers_row(self, slot: int) -> np.ndarray:
        """One query slot's final vertex states (a copy). [V]"""
        return _host_copy(self.state.cur[slot])

    def nbytes(self) -> int:
        return nbytes_accounted(self.cfg, self.state)

    def active_slots(self) -> list[int]:
        return torch.nonzero(self.state.active).flatten().tolist()

    def _slot_bytes(self) -> tuple[np.ndarray, np.ndarray | None, list[int]]:
        """Per slot, the Iterate operator's bytes that vary by slot (its
        change points and Det records), its J-store bytes (vdc, else None),
        and the live slots: reduced on the device, one transfer."""
        st = self.state
        per = st.dstore.count.sum(dim=1, dtype=torch.int64) * 8
        if st.drop.det is not None:
            per = per + st.drop.det.count.sum(dim=1, dtype=torch.int64) * 4
        rows = [per, st.active.to(torch.int64)]
        if st.jstore is not None:
            rows.append(st.jstore.count.sum(dim=1, dtype=torch.int64) * 8)
        host = torch.stack(rows).cpu().numpy()
        live = np.nonzero(host[1])[0].tolist()
        return host[0], (host[2] if st.jstore is not None else None), live

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
        st = self.state
        host = torch.stack(
            [st.repair_counts.sum(dim=1, dtype=torch.int64), st.active.to(torch.int64)]
        ).cpu().numpy()
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
            if self.state.jstore is not None:
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
        st = self.state
        if not bool(st.active[slot]):
            raise ValueError(f"slot {slot} is not active")
        if st.jstore is None:
            if materialize:
                raise ValueError(
                    "engine built without a join store (mode='jod'); build it with a "
                    "join-materializing plan"
                )
            return 0  # JOD engines hold no join differences to begin with
        if materialize == bool(st.join_mat[slot]):
            return 0
        join_mat = st.join_mat.clone()
        join_mat[slot] = materialize
        if not materialize:
            freed = int(st.jstore.count[slot].sum()) * 8
            iters, vals, count = (x.clone() for x in st.jstore)
            iters[slot], vals[slot], count[slot] = ds.IMAX, 0.0, 0
            self.state = st._replace(jstore=ds.DiffStore(iters, vals, count), join_mat=join_mat)
            return freed
        cur = st.cur.clone()
        cur[slot] = st.init[slot]
        self.state = st._replace(cur=cur, join_mat=join_mat)
        dirty = np.zeros((self.cfg.num_queries, self.cfg.num_vertices), bool)
        dirty[slot] = True
        self._run_counted(dirty)
        return 0

    def set_drop_params(self, slot: int, drop_cfg: dr.DropConfig, op_id: str = "iterate") -> int:
        """Rewrite a LIVE slot's drop policy for ONE operator.

        ``op_id="iterate"`` (default) rewrites the slot's §5 selection row
        and sheds its stored diffs under the new policy (:func:`shed_slot`).
        ``op_id="join"`` routes to :meth:`set_join_store`: an enabled config
        (complete dropping) drops the slot's join trace, a disabled one
        re-materializes it.  Returns the accounted bytes released (≥ 0 for
        iterate: a shed trades 8 B change points for ≤ 4 B DroppedVT records
        or Bloom bits).
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
        if not bool(self.state.active[slot]):
            raise ValueError(f"slot {slot} is not active")
        if self.state.drop.params is None:
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
        drop = self.state.drop
        self.state = self.state._replace(
            drop=drop._replace(params=dr.set_params_row(drop.params, slot, drop_cfg))
        )
        if drop_cfg.enabled():
            ovf_before = int(self.state.drop.det_overflow)
            self.state = shed_slot(self.cfg, self.state, self.g, slot)
            self.det_overflow_shed += int(self.state.drop.det_overflow) - ovf_before
        return before - self.slot_nbytes(slot)

    # ------------------------------------------------------------ durability
    def export_state(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) snapshot of the difference trace, host copies.

        The keys, dtypes and ``meta`` are the reference's, so a snapshot of
        either package imports into the other: stores as
        ``"{dstore,jstore,drop_det}/{iters,vals,count}"`` (the J store in
        its edge-slot layout ``[Q, E_cap, S_J]``, which is this engine's
        own), ``"drop_flt/bits"``, ``"drop/det_overflow"``,
        ``"drop/max_iter"``, ``"drop_params/<field>"`` (the seed as
        uint32), ``init``, ``cur``, ``repair_counts``, ``active`` and
        ``join_mat``.
        """
        st = self.state
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
        or the reference).  The engine must have been built for the same
        graph and slot capacity (an all-inactive pool skips the initial
        sweep, so building one is cheap)."""
        if int(meta["slot_capacity"]) != self.cfg.num_queries:
            raise ValueError(
                f"checkpoint has {meta['slot_capacity']} query slots but the "
                f"engine was built with {self.cfg.num_queries}"
            )

        def put(x) -> Tensor:
            return torch.from_numpy(np.array(x, copy=True)).to(self.device)

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
        self.state = EngineState(
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
            self.g = self._device_graph(self.graph.snapshot())
        self.last_stats = None
