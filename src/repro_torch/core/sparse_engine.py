"""Work-efficient host execution of Diff-IFE (the paper's pointer machine).

The port of ``repro/core/sparse_engine.py``: numpy on the host in the
reference and here, unchanged but for the package it imports.

The dense engine (`core.engine`) sweeps O(E)-wide masked lanes — ideal
for accelerators, but per-update wall clock is flat in |affected set|.  A
GDBMS also serves small-update workloads from the host, where the paper's
original pointer design wins: hash-map difference indexes, per-iteration
frontier sets, and join work proportional to the touched neighbourhood.

This module is that host path: same eager-merged change-point semantics,
same JOD direct/upper-bound rules, numpy/dict state.  It reproduces the
paper's Table-1 shape in *wall clock* (maintenance cost ∝ affected set, not
graph size) and is cross-validated against both the dense engine and
SCRATCH by property tests.

Queries are registered as :class:`~repro_torch.core.plan.QueryPlan`s — the same
IR the dense engine consumes — so the host engine satisfies the session
``EngineProtocol`` (`core/session.py`): ``register_plan`` computes the new
query's difference trace from the live adjacency, ``deregister_plan`` drops
its index and returns the bytes released.  The legacy
``SparseDiffIFE(graph, sources, ...)`` constructor builds SSSP/K-hop plans
internally.

Supports the min-family semirings (SPSP/SSSP, K-hop/RPQ reachability, WCC
label propagation) — the query classes the paper's scalability study runs.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Sequence

import numpy as np

from repro_torch.core import dropping as dr
from repro_torch.core import plan as qp
from repro_torch.core.engine import ITER_TRACE, MaintainStats
from repro_torch.core.graph import DynamicGraph
from repro_torch.obs import trace as obs_trace

INF = float("inf")


class SparseDiffIFE:
    """Host CQP: JOD + eager merging with pointer data structures.

    State per registered query slot q:
      diffs[q][v]   sorted list of (iteration, value) change points
      init_rows[q]  the implicit iteration-0 states (never stored as diffs)
    Graph adjacency lives in dicts of dicts (in/out), mirroring a GDBMS
    adjacency-list index.
    """

    def __init__(
        self,
        graph: DynamicGraph,
        sources: Sequence[int] | None = None,
        *,
        max_iters: int = 64,
        khop: int | None = None,  # legacy: None = min_plus; else hop query
    ) -> None:
        self.graph = graph
        self.max_iters = int(max_iters)
        self.in_nbrs: dict[int, dict[int, float]] = defaultdict(dict)
        self.out_nbrs: dict[int, dict[int, float]] = defaultdict(dict)
        for e in np.nonzero(graph.valid)[0]:
            u, v, w = int(graph.src[e]), int(graph.dst[e]), float(graph.weight[e])
            self.out_nbrs[u][v] = w
            self.in_nbrs[v][u] = w
        self.plans: dict[int, qp.QueryPlan] = {}
        self.diffs: dict[int, dict[int, list[tuple[int, float]]]] = {}
        self._init_rows: dict[int, np.ndarray] = {}
        self._free: list[int] = []
        self._num_slots = 0
        self.work = 0  # aggregator re-runs (the paper's work metric)
        self.work_per_slot: dict[int, int] = {}  # per-query recompute signal
        # governor scratch fallback: slots whose difference index was dropped
        # entirely — answers re-executed from scratch per batch (slot → row)
        self._scratch_rows: dict[int, np.ndarray] = {}
        self.last_stats: MaintainStats | None = None  # last sweep, dense schema
        # recorded policies, keyed slot (iterate) or (slot, op_id)
        self._drop_cfg: dict = {}
        self.sources = [] if sources is None else [int(s) for s in sources]
        for s in self.sources:
            if khop is not None:
                self.register_plan(qp.khop(s, k=int(khop)))
                self.max_iters = int(max_iters)  # legacy: cap ≠ sweep bound
            else:
                self.register_plan(qp.sssp(s, max_iters=max_iters))

    # ---------------------------------------------------------------- slots
    def register_plan(self, plan: qp.QueryPlan) -> int:
        """Register one query: claim a slot, compute its trace from the live
        adjacency (the static IFE run, recorded as change points)."""
        if plan.semiring.reduce != "min":
            raise ValueError(
                f"host engine supports min-family semirings only, "
                f"got {plan.semiring.name!r}"
            )
        slot = self._free.pop() if self._free else self._num_slots
        self._num_slots = max(self._num_slots, slot + 1)
        self.plans[slot] = plan
        self.diffs[slot] = defaultdict(list)
        self._init_rows[slot] = plan.build_init(self.graph.num_vertices)
        self.work_per_slot[slot] = 0
        self.max_iters = max(self.max_iters, int(plan.max_iters))
        self._initial(slot)
        return slot

    def deregister_plan(self, slot: int) -> int:
        """Drop a query's difference index; returns the bytes released."""
        if slot not in self.plans:
            raise ValueError(f"slot {slot} is not registered")
        freed = self.slot_nbytes(slot)
        del self.plans[slot], self.diffs[slot], self._init_rows[slot]
        self._scratch_rows.pop(slot, None)
        self._drop_cfg.pop(slot, None)
        self._drop_cfg.pop((slot, "join"), None)
        self.work_per_slot.pop(slot, None)
        self._free.append(slot)
        self._free.sort(reverse=True)
        return freed

    def active_slots(self) -> list[int]:
        return sorted(self.plans)

    # ----------------------------------------------------- governor surface
    def slot_nbytes(self, slot: int) -> int:
        return sum(len(p) for p in self.diffs[slot].values()) * 8

    def nbytes_per_query(self) -> dict[int, int]:
        """slot → accounted diff bytes (scratch-fallback slots hold none)."""
        return {s: self.slot_nbytes(s) for s in sorted(self.plans)}

    def nbytes_per_operator(self) -> dict[int, dict[str, int]]:
        """slot → {op_id → bytes}: the host engine is the paper's pointer
        machine — JOD by construction, so the Iterate's difference index is
        the only store (the Join's differences are always recomputed)."""
        return {s: {"iterate": self.slot_nbytes(s)} for s in sorted(self.plans)}

    def recompute_cost_per_query(self) -> dict[int, int]:
        """slot → cumulative aggregator re-runs charged to that query."""
        return {s: self.work_per_slot.get(s, 0) for s in sorted(self.plans)}

    def recompute_cost_per_operator(self) -> dict[int, dict[str, int]]:
        return {
            s: {"iterate": self.work_per_slot.get(s, 0)}
            for s in sorted(self.plans)
        }

    def set_drop_params(
        self, slot: int, cfg: dr.DropConfig, op_id: str = "iterate"
    ) -> int:
        """Host form of the policy ladder — two effective rungs.

        The pointer engine has no DroppedVT repair path, so partial rungs
        (0 < p < 1) are recorded but shed nothing; **drop-all** (p ≥ 1)
        triggers the scratch fallback: the slot's whole difference index is
        released and its answers are re-executed from scratch per batch
        (paper's SCRATCH endpoint, applied per query).  De-escalating below
        drop-all rebuilds the index from the live adjacency (one static IFE
        run — register-convergence makes this exact).  Returns bytes freed.

        ``op_id="join"`` is a recorded no-op: the pointer engine never
        materializes the Join's differences (it is the paper's JOD machine),
        so there is nothing to drop or re-materialize.
        """
        if slot not in self.plans:
            raise ValueError(f"slot {slot} is not registered")
        if op_id == "join":
            self._drop_cfg[(slot, "join")] = cfg
            return 0
        if op_id != "iterate":
            raise ValueError(
                f"operator {op_id!r} owns no engine difference store"
            )
        self._drop_cfg[slot] = cfg
        scratch = cfg.drops_all()
        if scratch and slot not in self._scratch_rows:
            freed = self.slot_nbytes(slot)
            self.diffs[slot] = defaultdict(list)
            self._scratch_rows[slot] = self._scratch_eval(slot)
            return freed
        if not scratch and slot in self._scratch_rows:
            del self._scratch_rows[slot]
            self.diffs[slot] = defaultdict(list)
            self._initial(slot)  # rebuild the trace from the live adjacency
        return 0

    def _scratch_eval(self, q: int) -> np.ndarray:
        """Static IFE run to fixpoint — value rows only, no change points.

        This is the host engine's repair-on-access path: the slot's trace
        was dropped entirely, so answers are recomputed from the live
        adjacency (traced under the ``repair`` category).
        """
        with obs_trace.span("scratch_eval", "repair", pid="engine:host", tid=q):
            return self._scratch_eval_inner(q)

    def _scratch_eval_inner(self, q: int) -> np.ndarray:
        vals = np.asarray(self._init_rows[q], np.float32).copy()
        for _ in range(self.max_iters):
            nxt = vals.copy()
            for v, ins in self.in_nbrs.items():
                best = nxt[v]
                for u, w in ins.items():
                    cand = self._msg(q, float(vals[u]), w)
                    if cand < best:
                        best = cand
                nxt[v] = best
                self.work += 1
                self.work_per_slot[q] = self.work_per_slot.get(q, 0) + 1
            if np.array_equal(nxt, vals):
                break
            vals = nxt
        return vals

    # ------------------------------------------------------------- semiring
    def _msg(self, q: int, val: float, w: float) -> float:
        s = self.plans[q].semiring
        if s.name == "min_plus":
            return val + w
        if s.name == "min_hop":
            nxt = val + 1.0
            return nxt if nxt <= s.hop_cap else INF
        if s.name == "min_label":
            return val
        raise ValueError(f"unsupported semiring {s.name!r}")

    # ---------------------------------------------------------------- state
    def _value_at(self, q: int, v: int, i: int) -> float:
        """Latest change point ≤ i (implicit init from the plan's D_0)."""
        best = float(self._init_rows[q][v])
        for (it, val) in self.diffs[q].get(v, ()):
            if it <= i:
                best = val
            else:
                break
        return best

    def _recompute(self, q: int, v: int, i: int) -> float:
        """Rerun the aggregator (Min) for v at iteration i — the join is
        computed on demand from in-neighbour states at i−1 (JOD §4)."""
        self.work += 1
        self.work_per_slot[q] = self.work_per_slot.get(q, 0) + 1
        best = self._value_at(q, v, i - 1)  # carry (includes implicit init)
        for u, w in self.in_nbrs.get(v, {}).items():
            cand = self._msg(q, self._value_at(q, u, i - 1), w)
            if cand < best:
                best = cand
        return best

    def _set_point(self, q: int, v: int, i: int, val: float) -> tuple[int, int]:
        """Upsert/cancel the change point at iteration ``i``; returns
        (written, removed) — 1/0 flags for the sweep's stat counters."""
        pts = self.diffs[q][v]
        prev = self._value_at(q, v, i - 1)
        # drop/replace any existing point at i, then insert if a true change
        n0 = len(pts)
        pts[:] = [(it, x) for (it, x) in pts if it != i]
        had = len(pts) < n0
        wrote = val != prev
        if wrote:
            pts.append((i, val))
            pts.sort()
        if not pts:
            del self.diffs[q][v]
        return int(wrote), int(had and not wrote)

    # ------------------------------------------------------------ procedures
    def _initial(self, q: int) -> None:
        # vertices with a non-identity implicit init feed their
        # out-neighbours at iteration 1 (SSSP: the source; WCC: everyone)
        ident = self.plans[q].semiring.identity
        seeds = {
            int(v) for v in np.nonzero(self._init_rows[q] != ident)[0]
        }
        frontier = set(seeds)
        for s in seeds:
            frontier.update(self.out_nbrs.get(s, ()))
        for i in range(1, self.max_iters + 1):
            nxt: set[int] = set()
            for v in sorted(frontier):
                new = self._recompute(q, v, i)
                if new != self._value_at(q, v, i):
                    self._set_point(q, v, i, new)
                    nxt.add(v)
                    nxt.update(self.out_nbrs.get(v, ()))
            # values settled at i propagate to consumers at i+1
            frontier = {v for v in nxt}
            if not frontier:
                break

    def _horizon(self, q: int) -> int:
        h = 0
        for pts in self.diffs[q].values():
            if pts:
                h = max(h, pts[-1][0])
        return h

    def apply_updates(self, updates) -> MaintainStats:
        """One δE batch: update adjacency, then per-query sparse sweep.

        Returns (and keeps in ``last_stats``) the dense engine's
        :class:`MaintainStats` schema so telemetry / governor / metrics see
        one uniform shape across engines.  The pointer machine has no
        DroppedVT path, so ``dropped`` / ``jwritten`` / ``det_overflow``
        are structurally zero; scratch-fallback re-executions (the host's
        repair-on-access analog) land in ``repairs``.
        """
        dirty: set[int] = set()
        for (u, v, _lbl, w, sign) in updates:
            u, v = int(u), int(v)
            if sign > 0:
                self.out_nbrs[u][v] = float(w)
                self.in_nbrs[v][u] = float(w)
            else:
                self.out_nbrs.get(u, {}).pop(v, None)
                self.in_nbrs.get(v, {}).pop(u, None)
            dirty.add(v)
        self.graph.apply_batch(updates)

        iters_max = 0
        scheduled = changed = repairs = written = removed = 0
        sched_sizes = np.zeros(ITER_TRACE, np.int64)
        frontier_sizes = np.zeros(ITER_TRACE, np.int64)
        sweep = obs_trace.span(
            "sweep", "sweep", pid="engine:host", num_updates=len(updates)
        )
        with sweep:
            for q in sorted(self.plans):
                if q in self._scratch_rows:  # drop-all: re-execute, no diffs
                    w0 = self.work
                    self._scratch_rows[q] = self._scratch_eval(q)
                    repairs += self.work - w0
                    continue
                horizon = self._horizon(q)
                frontier: set[int] = set()
                # Retractions are not monotone: a vertex raised at iteration
                # i may regain a lower value at a later iteration from an
                # in-neighbour whose change point settles later.  Every
                # vertex touched by this sweep therefore stays scheduled
                # through the trace horizon — exactly the treatment the
                # direct update heads (`dirty`) already get — instead of
                # dropping out of the frontier at its first unchanged
                # iteration.
                touched: set[int] = set()
                i = 1
                while i <= self.max_iters and (
                    frontier or ((dirty or touched) and i <= horizon + 1)
                ):
                    sched = frontier | (
                        (dirty | touched) if i <= horizon + 1 else set()
                    )
                    nxt: set[int] = set()
                    for v in sorted(sched):
                        old = self._value_at(q, v, i)
                        new = self._recompute(q, v, i)
                        if new != old:
                            nxt.add(v)
                            nxt.update(self.out_nbrs.get(v, ()))
                            touched.add(v)
                        w_, r_ = self._set_point(q, v, i, new)
                        written += w_
                        removed += r_
                    bin_i = min(i - 1, ITER_TRACE - 1)
                    scheduled += len(sched)
                    changed += len(nxt)
                    sched_sizes[bin_i] += len(sched)
                    frontier_sizes[bin_i] += len(nxt)
                    horizon = max(horizon, self._horizon(q))
                    frontier = nxt
                    i += 1
                iters_max = max(iters_max, i - 1)

            z = np.int32
            self.last_stats = MaintainStats(
                iters_run=z(iters_max),
                scheduled=z(scheduled),
                changed=z(changed),
                repairs=z(repairs),
                written=z(written),
                removed=z(removed),
                dropped=z(0),
                jwritten=z(0),
                det_overflow=z(0),
                sched_sizes=sched_sizes.astype(np.int32),
                frontier_sizes=frontier_sizes.astype(np.int32),
            )
            sweep.set(
                iters_run=iters_max, scheduled=scheduled, changed=changed,
                repairs=repairs, written=written, removed=removed,
            )
        return self.last_stats

    def apply_updates_batched(self, updates, batch_size: int | None = None):
        """Protocol twin of the dense engine's chunked path: the host sweep
        is already per-update work-efficient, so this just applies the log."""
        del batch_size
        return self.apply_updates(list(updates))

    # ------------------------------------------------------------------ api
    def answers_row(self, slot: int) -> np.ndarray:
        if slot in self._scratch_rows:
            return self._scratch_rows[slot].copy()
        out = np.asarray(self._init_rows[slot], np.float32).copy()
        for vtx, pts in self.diffs[slot].items():
            if pts:
                out[vtx] = pts[-1][1]
        return out

    def answers(self) -> np.ndarray:
        """[num_slots, V] over every slot ever allocated (deregistered slots
        read as the identity row) — slot-aligned with the dense engine."""
        v = self.graph.num_vertices
        out = np.full((self._num_slots, v), np.inf, np.float32)
        for slot in self.plans:
            out[slot] = self.answers_row(slot)
        return out

    def nbytes(self) -> int:
        return self.num_diffs() * 8

    def num_diffs(self) -> int:
        return sum(
            len(p) for q in self.plans for p in self.diffs[q].values()
        )

    # ------------------------------------------------------------ durability
    def export_state(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) snapshot: change points flattened to parallel
        arrays, plans/policies/work counters as JSON-able meta.  Adjacency is
        NOT saved — it is rebuilt from the restored :class:`DynamicGraph`."""
        slots: list[int] = []
        vtxs: list[int] = []
        its: list[int] = []
        vals: list[float] = []
        for s in sorted(self.diffs):
            for v in sorted(self.diffs[s]):
                for (i, val) in self.diffs[s][v]:
                    slots.append(s)
                    vtxs.append(v)
                    its.append(i)
                    vals.append(val)
        arrays = {
            "diff_slot": np.asarray(slots, np.int64),
            "diff_vtx": np.asarray(vtxs, np.int64),
            "diff_iter": np.asarray(its, np.int64),
            "diff_val": np.asarray(vals, np.float64),
        }
        for s, row in self._scratch_rows.items():
            arrays[f"scratch_row/{s}"] = np.asarray(row, np.float32)
        drop_cfg = []
        for key, cfg in self._drop_cfg.items():
            slot, op = (key if isinstance(key, tuple) else (key, None))
            drop_cfg.append({
                "slot": int(slot),
                "op": op,
                "cfg": None if cfg is None else dataclasses.asdict(cfg),
            })
        meta = {
            "num_slots": int(self._num_slots),
            "free_slots": [int(s) for s in self._free],
            "max_iters": int(self.max_iters),
            "work": int(self.work),
            "work_per_slot": {str(s): int(w) for s, w in self.work_per_slot.items()},
            "plans": {str(s): p.to_json() for s, p in self.plans.items()},
            "drop_cfg": drop_cfg,
            "sources": [int(s) for s in self.sources],
        }
        return arrays, meta

    def import_state(self, arrays: dict, meta: dict) -> None:
        """Load a snapshot produced by :meth:`export_state`.  The engine
        must have been constructed on the restored graph (adjacency dicts
        come from the constructor); init rows rebuild deterministically from
        each plan."""
        self.plans = {
            int(s): qp.QueryPlan.from_json(p) for s, p in meta["plans"].items()
        }
        self._num_slots = int(meta["num_slots"])
        self._free = [int(s) for s in meta["free_slots"]]
        self.max_iters = int(meta["max_iters"])
        self.work = int(meta["work"])
        self.work_per_slot = {
            int(s): int(w) for s, w in meta["work_per_slot"].items()
        }
        self.sources = [int(s) for s in meta.get("sources", [])]
        self.diffs = {s: defaultdict(list) for s in self.plans}
        for s, v, i, val in zip(
            arrays["diff_slot"], arrays["diff_vtx"],
            arrays["diff_iter"], arrays["diff_val"],
        ):
            # saved in per-(slot, vertex) list order, so the sorted-by-
            # iteration change-point invariant is preserved verbatim
            self.diffs[int(s)][int(v)].append((int(i), float(val)))
        self._init_rows = {
            s: p.build_init(self.graph.num_vertices) for s, p in self.plans.items()
        }
        self._scratch_rows = {
            int(k.split("/", 1)[1]): np.asarray(arrays[k], np.float32)
            for k in arrays
            if k.startswith("scratch_row/")
        }
        self._drop_cfg = {}
        for entry in meta["drop_cfg"]:
            key = (
                (int(entry["slot"]), entry["op"])
                if entry["op"] is not None
                else int(entry["slot"])
            )
            cfg = entry["cfg"]
            self._drop_cfg[key] = None if cfg is None else dr.DropConfig(**cfg)
