"""The flagship rewrite: landmark hub-cut for SPSP plans (paper §6.6).

The port of ``repro/planner/landmark_rewrite.py``.  The index fields, the
triangle bounds and the pruned fields stay on the session's device; a read
copies one pruned row to the host.

Pattern: a min-plus, source-initialized, join/transform-free plan whose
Aggregate reads one target vertex (``plan.spsp(s, t)``).  Strategy: all
matching queries of a session share ONE landmark-index subplan —

* L forward SSSP fields over G, registered as *internal* queries of the
  host session (ordinary engine rows: operator-addressed difference
  stores, ``nbytes_per_operator`` rows, drop policies, governor ladder);
* L reverse SSSP fields over Gᵀ, held by a nested twin
  :class:`~repro_torch.core.session.CQPSession` on the transposed graph, fed the
  transposed δE of every ingested batch;

— and each query answers through a **pruned-scratch subquery**: a
Bellman-Ford re-run whose expansion is gated by the index's triangle
upper/lower bounds (:func:`repro_torch.core.landmark.triangle_bounds` →
:func:`repro_torch.core.landmark.pruned_scratch_run`).  Answers are exact
at the target (vertices on optimal paths are never pruned).  On a dense
session the forward rows are the engine's (``fused`` maintains them with
its kernel) and the pruned run reads the engine's device graph.

Governor lever: the whole index is one pseudo-operator row
``(PLANNER_QID, "landmark")`` in the victim table.  Escalation sheds it —
internal rows deregister, the twin session drops, bounds go trivial and the
subquery degrades to plain scratch (answers stay exact, latency rises);
de-escalation re-selects landmarks and re-materializes in-engine.  That is
the "landmark-ize / de-landmark-ize" memory↔latency rung.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import landmark as lm
from repro_torch.core import plan as qp
from repro_torch.planner.cost import CostModel
from repro_torch.planner.rules import INDEX_OP, PLANNER_QID, RewriteRule


def _rows(session, qids) -> torch.Tensor:
    """The answer rows of ``qids`` as one ``[n, V]`` tensor on the session's
    device: a dense engine's rows are gathered on the device (from every
    shard of a sharded one), the host and scratch engines' rows are
    uploaded."""
    from repro_torch.core.session import DenseEngine

    slots = [session._handles[q] for q in qids]
    if isinstance(session._impl, DenseEngine):
        return session._impl.impl.answer_rows(slots)
    rows = np.stack([session._impl.answers_row(s) for s in slots])
    return torch.from_numpy(rows).to(session.device)


def _device_graph(session):
    """An unsharded dense engine's device graph (kept current by every
    ingest), or ``None``: the pruned run then builds one from the graph's
    snapshot (a sharded engine's graph is split by destination)."""
    from repro_torch.core.session import DenseEngine

    if isinstance(session._impl, DenseEngine) and not session._impl.impl.sharded:
        return session._impl.impl.g
    return None


class LandmarkRule(RewriteRule):
    """Shared landmark-index runtime for one session's SPSP queries."""

    name = "landmark"
    pseudo_op = INDEX_OP

    def __init__(self, num_landmarks: int = 4):
        self.num_landmarks = int(num_landmarks)
        self.max_iters = 64  # pinned by the first admitted plan
        self.semiring = None  # likewise (matches() restricts to min_plus)
        # shared-index runtime (per session — one rule instance per planner)
        self.landmarks: list[int] = []
        self.fwd_qids: list[int] = []  # internal qids in the host session
        self.rev_session = None  # twin CQPSession over Gᵀ
        self.rev_handles: list = []
        self.shed = False  # governor holds the index de-materialized
        self.queries: dict[int, tuple[int, int]] = {}  # qid → (s, t)
        self._matrix: torch.Tensor | None = None  # [Q, V] pruned fields (device)
        self._order: list[int] = []  # matrix row ↔ qid
        self._dirty = False  # pruned fields recompute lazily on read
        # meters (fig9 / probes)
        self.sheds_total = 0
        self.remats_total = 0
        self.pruned_iters_last = 0
        self.pruned_work_total = 0
        self.scratch_seconds = 0.0

    # -------------------------------------------------------------- pattern
    def matches(self, plan: qp.QueryPlan, session) -> bool:
        agg = plan.aggregate
        return (
            plan.nfa is None
            and plan.op_of_kind("transform") is None
            and plan.semiring.name == "min_plus"
            and plan.init.kind == "source"
            and agg is not None
            and agg.agg == "target"
            and agg.vertex is not None
        )

    def pays(self, plan: qp.QueryPlan, session, cost: CostModel):
        est = cost.landmark(
            plan,
            session,
            num_landmarks=self.num_landmarks,
            sharers=len(self.queries) + 1,
        )
        return est.pays, est.to_dict()

    def rewrite(self, plan: qp.QueryPlan, session) -> qp.QueryPlan:
        return plan.with_provenance(
            qp.Provenance(
                rule=self.name,
                original_kind=plan.kind,
                params=(
                    ("source", int(plan.init.source)),
                    ("target", int(plan.aggregate.vertex)),
                    ("num_landmarks", self.num_landmarks),
                ),
            )
        )

    # -------------------------------------------------------------- runtime
    @property
    def _live(self) -> bool:
        return bool(self.fwd_qids)

    def admit(self, session, qid: int, plan: qp.QueryPlan) -> None:
        if not self.queries:
            self.max_iters = int(plan.max_iters)
            self.semiring = plan.semiring
        if not self._live and not self.shed:
            self._build_index(session)
        self.queries[qid] = (int(plan.init.source), int(plan.aggregate.vertex))
        self._dirty = True

    def release(self, session, qid: int) -> int:
        del self.queries[qid]
        if self.queries:
            self._dirty = True
            return 0
        # last sharer gone — the shared index tears down with it
        self._matrix, self._order = None, []
        return self._teardown(session)

    def on_updates(self, session, updates) -> None:
        if not self.queries:
            return
        if self._live:
            self.rev_session.apply_updates(lm.transpose_updates(updates))
        self._dirty = True

    def _ensure_fresh(self, session) -> None:
        """One pruned-scratch sweep serves every read since the last δE
        batch or admission — amortized like the engines' own batching."""
        if self._dirty or (self._matrix is None and self.queries):
            self._refresh(session)
            self._dirty = False

    def answers(self, session, qid: int) -> np.ndarray:
        """The pruned SSSP field [V] — exact at the query's target vertex;
        pruned vertices elsewhere may read +inf."""
        self._ensure_fresh(session)
        return self._matrix[self._order.index(qid)].to("cpu", copy=True).numpy()

    # ------------------------------------------------------- index build/run
    def _build_index(self, session) -> None:
        self.landmarks = lm.select_landmarks(session.graph, self.num_landmarks)
        self.fwd_qids = session._register_internal(
            [qp.sssp(l, max_iters=self.max_iters) for l in self.landmarks]
        )
        self.rev_session = self._twin_session(session)
        self.rev_handles = self.rev_session.register_many(
            [qp.sssp(l, max_iters=self.max_iters) for l in self.landmarks]
        )
        self.shed = False

    def _twin_session(self, session):
        from repro_torch.core.session import CQPSession

        # COO keeps the twin's sweep shape independent of Gᵀ's degree
        # distribution; no mesh — the index is L rows, not worth sharding
        return CQPSession(
            lm.transpose_graph(session.graph),
            engine=session.engine_kind,
            backend="coo",
            batch_capacity=session._kw["batch_capacity"],
            min_slots=max(self.num_landmarks, 1),
            device=session.device,
        )

    def _fields(self, session):
        if not self._live:
            return None, None
        return (
            _rows(session, self.fwd_qids),
            _rows(self.rev_session, [h.qid for h in self.rev_handles]),
        )

    def _refresh(self, session) -> None:
        """Recompute every owned query's pruned-scratch field."""
        if not self.queries:
            self._matrix, self._order = None, []
            return
        self._order = sorted(self.queries)
        sources = [self.queries[q][0] for q in self._order]
        targets = [self.queries[q][1] for q in self._order]
        fwd, rev = self._fields(session)
        cfg = lm.engine_cfg(
            len(self._order),
            session.graph.num_vertices,
            self.semiring,
            max_iters=self.max_iters,
        )
        t0 = time.perf_counter()
        self._matrix, self.pruned_iters_last, work = lm.pruned_scratch_run(
            cfg, session.graph, sources, targets, fwd, rev,
            g=_device_graph(session), device=session.device,
        )
        self.scratch_seconds += time.perf_counter() - t0
        self.pruned_work_total += work

    def _teardown(self, session) -> int:
        freed = 0
        if self.fwd_qids:
            freed += session._deregister_internal(self.fwd_qids)
            self.fwd_qids = []
        if self.rev_session is not None:
            freed += self.rev_session.nbytes()
            self.rev_session = None
            self.rev_handles = []
        self.landmarks = []
        self.shed = False
        if session._governor is not None:
            session._governor.on_deregister(PLANNER_QID)
        return freed

    # ------------------------------------------------------ byte accounting
    def extra_nbytes(self, session) -> int:
        return 0 if self.rev_session is None else self.rev_session.nbytes()

    def pseudo_ops(self, session) -> dict:
        if not self.queries:
            return {}
        # only the twin's bytes: the forward rows are already metered under
        # their internal qids (double counting would inflate the budget sum)
        return {(PLANNER_QID, INDEX_OP): self.extra_nbytes(session)}

    def pseudo_costs(self, session) -> dict:
        if not self.queries:
            return {}
        # shedding the index degrades the subquery to un-pruned scratch, so
        # its "recompute cost" is the pruned work it already pays (monotone)
        return {(PLANNER_QID, INDEX_OP): self.pruned_work_total}

    def set_policy(self, session, cfg) -> int:
        if cfg.enabled() and not self.shed:
            # shed: de-landmark-ize — answers stay exact through un-pruned
            # scratch, the 2·L maintained rows free their bytes
            freed = self._deregister_index(session)
            self.shed = True
            self.sheds_total += 1
            self._dirty = True
            return freed
        if not cfg.enabled() and self.shed:
            # re-materialize: fresh landmark selection (degrees may have
            # drifted), fields recomputed in-engine — still exact
            self._build_index(session)
            self.remats_total += 1
            self._dirty = True
            return 0
        return 0

    def _deregister_index(self, session) -> int:
        freed = 0
        if self.fwd_qids:
            freed += session._deregister_internal(self.fwd_qids)
            self.fwd_qids = []
        if self.rev_session is not None:
            freed += self.rev_session.nbytes()
            self.rev_session = None
            self.rev_handles = []
        self.landmarks = []
        return freed

    # ----------------------------------------------------------- durability
    def snapshot(self, session) -> dict:
        return {
            "queries": len(self.queries),
            "num_landmarks": self.num_landmarks,
            "landmarks": list(self.landmarks),
            "live": self._live,
            "shed": self.shed,
            "index_nbytes": self.extra_nbytes(session),
            "sheds_total": self.sheds_total,
            "remats_total": self.remats_total,
            "pruned_iters_last": self.pruned_iters_last,
            "pruned_work_total": self.pruned_work_total,
            "scratch_seconds": round(self.scratch_seconds, 6),
        }

    def state_dict(self, session) -> tuple[dict, dict]:
        arrays: dict = {}
        meta: dict = {
            "num_landmarks": self.num_landmarks,
            "max_iters": self.max_iters,
            "landmarks": list(self.landmarks),
            "fwd_qids": list(self.fwd_qids),
            "queries": [[int(q), s, t] for q, (s, t) in sorted(self.queries.items())],
            "shed": self.shed,
            "sheds_total": self.sheds_total,
            "remats_total": self.remats_total,
            "pruned_work_total": self.pruned_work_total,
            "rev": None,
        }
        if self.rev_session is not None:
            r_arrays, r_meta = self.rev_session.state_dict()
            arrays.update(
                {f"planner_rev/{k}": v for k, v in r_arrays.items()}
            )
            meta["rev"] = r_meta
        return arrays, meta

    def load_state(self, session, meta: dict, arrays: dict, owned: dict) -> None:
        if not meta:
            return
        self.num_landmarks = int(meta["num_landmarks"])
        self.max_iters = int(meta["max_iters"])
        if owned:
            self.semiring = next(iter(owned.values())).semiring
        else:
            from repro_torch.core import semiring as sr

            self.semiring = sr.min_plus()
        self.landmarks = [int(l) for l in meta["landmarks"]]
        self.fwd_qids = [int(q) for q in meta["fwd_qids"]]
        self.queries = {int(q): (int(s), int(t)) for q, s, t in meta["queries"]}
        self.shed = bool(meta["shed"])
        self.sheds_total = int(meta.get("sheds_total", 0))
        self.remats_total = int(meta.get("remats_total", 0))
        self.pruned_work_total = int(meta.get("pruned_work_total", 0))
        if meta["rev"] is not None:
            from repro_torch.core.session import CQPSession

            # the twin restores on the host session's device
            self.rev_session = CQPSession._from_state(
                {
                    k[len("planner_rev/"):]: v
                    for k, v in arrays.items()
                    if k.startswith("planner_rev/")
                },
                meta["rev"],
                device=session.device,  # unsharded whatever the host mesh: it is L rows
            )
            self.rev_handles = self.rev_session.handles()
        if self.queries:
            self._dirty = True
