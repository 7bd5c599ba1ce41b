"""CQPSession — the continuous query processor's client facade.

The port of ``repro/core/session.py``.  Clients register and deregister
recursive queries against one dynamic graph while δE batches stream in:

    sess = CQPSession(graph, engine="dense")            # or "host"/"scratch"
    h0 = sess.register(plan.sssp(0))
    h1 = sess.register(plan.khop(3, k=4))               # mid-stream is fine
    sess.apply_updates_batched(update_log)
    d = sess.answers(h0)                                # [V]
    freed = sess.deregister(h1)                         # bytes released

Every engine implements one :class:`EngineProtocol`:

    * ``"dense"``   — :class:`~repro_torch.core.engine.DiffIFE`'s padded
      query-slot pool (active mask, host free list, geometric regrow), on
      the CUDA device by default (``device="cpu"`` runs the plain PyTorch
      versions).
    * ``"host"``    — the pointer engine (`core/sparse_engine.py`), numpy.
    * ``"scratch"`` — from-scratch re-execution (`core/scratch.py`).

Plans in one session must share a **family** (`QueryPlan.family_key`): the
semiring, iteration bound, PageRank weight derivation and NFA fix the shape
of the sweep.  Per-query knobs — source vertex, drop selection policy — are
free per registration.  The DroppedVT *representation* (Det store vs Bloom
filter and capacities) is fixed per session by ``drop`` (or inferred from
the first registered plan).  RPQ plans carry an NFA: the session owns the
product-graph construction and translates base-graph updates into product
updates, so the engines never know about automata.  With ``budget_bytes``
a :class:`~repro_torch.core.governor.MemoryGovernor` enforces the byte
budget after every ingest, register and deregister.

Two pieces wait for their own slices of the port and raise
:class:`NotImplementedError`: the plan optimizer (``optimize`` other than
``"none"``, ROADMAP Queue 1 item 5) and ``checkpoint``/``restore``
(``checkpoint/store.py``, Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import dropping as dr
from repro_torch.core import plan as qp
from repro_torch.core.engine import DiffIFE, EngineConfig, MaintainStats, resolve_device
from repro_torch.core.governor import GovernorConfig, MemoryGovernor
from repro_torch.core.graph import DynamicGraph, product_graph
from repro_torch.core.scratch import ScratchEngine
from repro_torch.core.sparse_engine import SparseDiffIFE
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.probes import maintain_stats_dict, publish_session_metrics

ENGINES = ("dense", "host", "scratch")

PLANNER = "the plan optimizer's slice of the port (ROADMAP Queue 1 item 5)"
DURABILITY = "the durability slice of the port, checkpoint/store.py (ROADMAP Queue 1 item 3)"


# --------------------------------------------------------------------------- protocol
@runtime_checkable
class EngineProtocol(Protocol):
    """What a session expects from an engine: a runtime query lifecycle on
    one dynamic graph.  ``register_plan`` computes the new query's state
    in-engine; ``deregister_plan`` returns the accounted bytes released.
    Every per-query meter has an operator-granular refinement keyed
    ``(slot, op_id)``, and ``set_drop_params`` rewrites ONE operator's
    policy (``"iterate"``: §5 selection params; ``"join"``: complete
    dropping / re-materialization of the join trace)."""

    def register_plan(self, plan: qp.QueryPlan) -> int: ...

    def deregister_plan(self, slot: int) -> int: ...

    def apply_updates(self, updates): ...

    def apply_updates_batched(self, updates, batch_size: int | None = None): ...

    def answers_row(self, slot: int) -> np.ndarray: ...

    def answers(self) -> np.ndarray: ...

    def nbytes(self) -> int: ...

    def nbytes_per_query(self) -> dict[int, int]: ...

    def nbytes_per_operator(self) -> dict[int, dict[str, int]]: ...

    def recompute_cost_per_query(self) -> dict[int, int]: ...

    def recompute_cost_per_operator(self) -> dict[int, dict[str, int]]: ...

    def set_drop_params(self, slot: int, cfg: dr.DropConfig, op_id: str = "iterate") -> int: ...

    def active_slots(self) -> list[int]: ...


def engine_config_for(
    first_plan: qp.QueryPlan,
    *,
    num_queries: int,
    num_vertices: int,
    mode: str = "jod",
    drop: dr.DropConfig | None = None,
    store_capacity: int = 16,
    jstore_capacity: int = 8,
    backend: str = "coo",
) -> EngineConfig:
    """The :class:`EngineConfig` of a plan family.

    ``backend`` picks the sweep: ``"coo"`` (scatter-reduce), ``"ell"`` (the
    CUDA bucketed-ELL SpMV as aggregator, JOD only) or ``"fused"`` (the CUDA
    maintenance kernel, one launch per iteration).  ``drop`` passes through
    unchanged."""
    return EngineConfig(
        num_queries=num_queries,
        num_vertices=num_vertices,
        max_iters=int(first_plan.max_iters),
        semiring=first_plan.semiring,
        mode=mode,
        store_capacity=store_capacity,
        jstore_capacity=jstore_capacity,
        drop=drop or dr.DropConfig(),
        weight_from_degree=first_plan.weight_from_degree,
        alpha=first_plan.alpha,
        backend=backend,
    )


# --------------------------------------------------------------------------- dense adapter
class DenseEngine:
    """Session protocol over :class:`DiffIFE`'s query-slot pool."""

    def __init__(
        self,
        graph: DynamicGraph,
        first_plan: qp.QueryPlan,
        *,
        drop_spec: dr.DropConfig,
        mode: str = "jod",
        backend: str = "coo",
        store_capacity: int = 16,
        jstore_capacity: int = 8,
        batch_capacity: int = 32,
        min_slots: int = 1,
        device=None,
    ) -> None:
        q_cap = 1 << (max(int(min_slots), 1) - 1).bit_length()
        v = graph.num_vertices
        cfg = engine_config_for(
            first_plan,
            num_queries=q_cap,
            num_vertices=v,
            mode=mode,
            drop=drop_spec,
            store_capacity=store_capacity,
            jstore_capacity=jstore_capacity,
            backend=backend,
        )
        init = np.full((q_cap, v), first_plan.semiring.identity, np.float32)
        self.impl = DiffIFE(
            cfg, graph, init, batch_capacity=batch_capacity, active=np.zeros(q_cap, bool),
            device=device,
        )

    def _join_flag(self, plan: qp.QueryPlan) -> bool | None:
        """The plan's Join materialization flag for the engine slot; a plan
        that materializes its Join needs an engine with a join store."""
        policy = plan.join_policy()
        if policy == "materialize" and self.impl.state.jstore is None:
            raise ValueError(
                "plan materializes the Join but the session engine runs JOD "
                "(no join store); include a join-materializing plan in the "
                "opening batch or open the session with mode='vdc'"
            )
        return policy != "drop"

    def register_plan(self, plan: qp.QueryPlan) -> int:
        return self.register_plans([plan])[0]

    def register_plans(self, plans: list[qp.QueryPlan]) -> list[int]:
        v = self.impl.cfg.num_vertices
        flags = [self._join_flag(p) for p in plans]  # the whole batch, before any slot
        return self.impl.register_slots(
            [(p.build_init(v), p.drop, f) for p, f in zip(plans, flags)]
        )

    def deregister_plan(self, slot: int) -> int:
        return self.impl.deregister_slot(slot)

    def apply_updates(self, updates):
        return self.impl.apply_updates(updates)

    def apply_updates_batched(self, updates, batch_size: int | None = None):
        return self.impl.apply_updates_batched(updates, batch_size=batch_size)

    def answers_row(self, slot: int) -> np.ndarray:
        return self.impl.answers_row(slot)

    def answers(self) -> np.ndarray:
        return self.impl.answers()

    def nbytes(self) -> int:
        return self.impl.nbytes()

    def nbytes_per_query(self) -> dict[int, int]:
        return self.impl.nbytes_per_query()

    def nbytes_per_operator(self) -> dict[int, dict[str, int]]:
        return self.impl.nbytes_per_operator()

    def recompute_cost_per_query(self) -> dict[int, int]:
        return self.impl.recompute_cost_per_query()

    def recompute_cost_per_operator(self) -> dict[int, dict[str, int]]:
        return self.impl.recompute_cost_per_operator()

    def set_drop_params(self, slot: int, cfg: dr.DropConfig, op_id: str = "iterate") -> int:
        return self.impl.set_drop_params(slot, cfg, op_id=op_id)

    @property
    def det_overflow_shed(self) -> int:
        return self.impl.det_overflow_shed

    @property
    def last_stats(self):
        return self.impl.last_stats

    def active_slots(self) -> list[int]:
        return self.impl.active_slots()


# --------------------------------------------------------------------------- handles
@dataclasses.dataclass(frozen=True)
class QueryHandle:
    """Opaque ticket for one registered query (stable across slot reuse)."""

    qid: int
    plan: qp.QueryPlan


# --------------------------------------------------------------------------- session
class CQPSession:
    """Runtime query lifecycle over one dynamic graph and one engine.

    See the module docstring for the model.  Keyword knobs mirror the dense
    engine's; ``"host"``/``"scratch"`` accept and ignore the dense-only
    ones.  ``device=None`` is the CUDA device (and raises without one) for
    every engine; ``"host"`` computes in numpy whatever the device.
    """

    def __init__(
        self,
        graph: DynamicGraph,
        *,
        engine: str = "dense",
        mesh=None,
        mode: str = "jod",
        backend: str = "coo",
        drop: dr.DropConfig | None = None,
        store_capacity: int = 16,
        jstore_capacity: int = 8,
        batch_capacity: int = 32,
        min_slots: int = 1,
        product_capacity: int | None = None,
        budget_bytes: int | None = None,
        governor: GovernorConfig | None = None,
        optimize: str = "none",
        device=None,
    ) -> None:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
        if optimize not in ("none", "auto", "always"):
            raise ValueError(f"unknown optimize mode {optimize!r}; choose none | auto | always")
        if optimize != "none":
            raise NotImplementedError(f"optimize={optimize!r} is not ported yet: it comes with {PLANNER}")
        if mesh is not None:
            if engine != "dense":
                raise ValueError("mesh sharding is a dense-engine feature")
            raise NotImplementedError(
                "the vertex-sharded sweep (mesh=) is not ported yet: it comes "
                "with the sharded slice of the port (ROADMAP Queue 1 item 4)"
            )
        if governor is not None and budget_bytes is None:
            raise ValueError("a GovernorConfig needs budget_bytes to enforce")
        self.device = resolve_device(device)
        self._governor: MemoryGovernor | None = None
        if budget_bytes is not None:
            gcfg = governor or GovernorConfig()
            if engine == "dense":
                # the governor escalates by rewriting DropParams rows, so the
                # dense engine needs a DroppedVT representation provisioned
                # up front (p = 0: nothing drops until an escalation)
                if drop is None:
                    drop = gcfg.representation_config()
                elif not drop.enabled():
                    raise ValueError(
                        "budget_bytes on a dense session needs an enabled "
                        "DroppedVT representation (drop=None auto-provisions "
                        "one; drop.mode='none' leaves the governor no lever)"
                    )
                elif drop.mode != gcfg.representation:
                    # the session's representation is fixed by `drop`; the
                    # ladder escalates within it
                    gcfg = dataclasses.replace(gcfg, representation=drop.mode)
            self._governor = MemoryGovernor(int(budget_bytes), gcfg)
        self.graph = graph
        self.engine_kind = engine
        self._kw = dict(
            mode=mode,
            backend=backend,
            store_capacity=store_capacity,
            jstore_capacity=jstore_capacity,
            batch_capacity=batch_capacity,
            min_slots=min_slots,
        )
        self._drop_spec = drop
        self._product_capacity = product_capacity
        self._impl: EngineProtocol | None = None
        self._family: tuple | None = None
        self._family_plan: qp.QueryPlan | None = None  # fixed the sweep shape
        self._nfa: qp.NFA | None = None
        self._egraph: DynamicGraph = graph  # product graph under an NFA family
        self._handles: dict[int, int] = {}  # qid → engine slot
        self._plans: dict[int, qp.QueryPlan] = {}
        self._next_qid = 0
        # lifetime counters (stats())
        self.registered_total = 0
        self.deregistered_total = 0
        self.updates_applied = 0
        self.bytes_freed_total = 0
        self.bytes_shed_total = 0  # reclaimed by drop-policy rewrites

    # ------------------------------------------------------------ lifecycle
    def register(self, plan: qp.QueryPlan, *, optimize: str | None = None) -> QueryHandle:
        """Register one query; its trace is computed in-engine (mid-stream
        registration converges to the same answers as from-start)."""
        return self.register_many([plan], optimize=optimize)[0]

    def register_many(
        self, plans: list[qp.QueryPlan], *, optimize: str | None = None
    ) -> list[QueryHandle]:
        """Register a batch of queries — the dense engine computes all of
        their traces in ONE maintenance sweep.

        Atomic: a rejected batch (family mismatch, drop-mode conflict, an
        engine that cannot run the family) leaves the session exactly as it
        was, including across the deferred first engine build.
        """
        if optimize not in (None, "none"):
            if optimize not in ("auto", "always"):
                raise ValueError(f"unknown optimize mode {optimize!r}; choose none | auto | always")
            raise NotImplementedError(f"optimize={optimize!r} is not ported yet: it comes with {PLANNER}")
        if not plans:
            return []
        plans = list(plans)
        qids = self._register_engine_plans(plans)
        handles = [QueryHandle(qid=qid, plan=self._plans[qid]) for qid in qids]
        self._govern()
        return handles

    def _register_engine_plans(self, plans: list[qp.QueryPlan]) -> list[int]:
        """The engine-slot registration path: validate the whole batch,
        commit the family, build the engine on first use, unwind on any
        failure."""
        base = self._family if self._family is not None else plans[0].family_key()
        spec = self._drop_spec
        if spec is None and self._impl is None:
            spec = next((p.drop for p in plans if p.drop.enabled()), None)
        for plan in plans:
            self._check_family(plan, base)
            if plan.drop.enabled() and spec is not None and plan.drop.mode != spec.mode:
                raise ValueError(
                    f"plan drop mode {plan.drop.mode!r} does not match the "
                    f"session's DroppedVT representation {spec.mode!r}"
                )
        fresh = self._impl is None
        saved = (self._family, self._nfa, self._drop_spec, self._egraph)
        if self._family is None:
            self._family = base
            self._nfa = plans[0].nfa
        try:
            if fresh:
                self._build_engine(plans)
            if hasattr(self._impl, "register_plans"):
                slots = self._impl.register_plans(plans)
            else:
                slots = []
                try:
                    for p in plans:
                        slots.append(self._impl.register_plan(p))
                except Exception:
                    for s in slots:
                        self._impl.deregister_plan(s)
                    raise
        except Exception:
            # unwind what this call committed (an engine built for this
            # batch is discarded)
            if fresh:
                self._impl = None
                self._family, self._nfa, self._drop_spec, self._egraph = saved
            raise
        qids: list[int] = []
        for plan, slot in zip(plans, slots):
            qid = self._next_qid
            self._next_qid += 1
            self._handles[qid] = slot
            self._plans[qid] = plan
            self.registered_total += 1
            if self._governor is not None:
                self._governor.on_register(qid, plan)
            qids.append(qid)
        return qids

    def deregister(self, handle: QueryHandle) -> int:
        """Retire a query: its difference rows are emptied and the accounted
        bytes released are returned; the slot returns to the free pool."""
        slot = self._slot(handle)
        freed = self._impl.deregister_plan(slot)
        del self._handles[handle.qid], self._plans[handle.qid]
        self.deregistered_total += 1
        self.bytes_freed_total += freed
        if self._governor is not None:
            self._governor.on_deregister(handle.qid)
        self._govern()
        return freed

    def _slot(self, handle: QueryHandle) -> int:
        if handle.qid not in self._handles:
            raise ValueError(f"handle {handle.qid} is not registered")
        return self._handles[handle.qid]

    def _check_family(self, plan: qp.QueryPlan, base: tuple) -> None:
        """Validate a plan against ``base`` (the session family, or the
        first plan of the opening batch); pure, so a rejected batch leaves
        the session untouched."""
        key = plan.family_key()
        if key != base:
            raise ValueError(
                "plan family mismatch: a session compiles ONE sweep shape "
                f"(semiring/max_iters/NFA); got {key} vs {base}. "
                "Open a second session for a different query family."
            )

    # ------------------------------------------------------- engine build
    def _build_engine(self, plans: list[qp.QueryPlan]) -> None:
        first_plan = plans[0]
        self._family_plan = first_plan
        if self._drop_spec is None:
            # the representation comes from the first drop-enabled plan of
            # the opening batch; later plans may use any selection params
            # under the same mode
            self._drop_spec = next((p.drop for p in plans if p.drop.enabled()), first_plan.drop)
        if self._nfa is not None:
            self._egraph = self._build_product_graph()
        if self.engine_kind == "dense":
            kw = dict(self._kw)
            # size the slot pool for the opening batch
            kw["min_slots"] = max(int(kw["min_slots"]), len(plans))
            # a plan whose Join node materializes its trace needs the VDC
            # join store
            if any(p.join_policy() == "materialize" for p in plans):
                kw["mode"] = "vdc"
            self._impl = DenseEngine(
                self._egraph, first_plan, drop_spec=self._drop_spec, device=self.device, **kw
            )
        elif self.engine_kind == "host":
            self._impl = SparseDiffIFE(self._egraph, max_iters=int(first_plan.max_iters))
        else:
            cfg = engine_config_for(
                first_plan,
                num_queries=1,
                num_vertices=self._egraph.num_vertices,
                backend=self._kw["backend"],
            )
            self._impl = ScratchEngine(cfg, self._egraph, device=self.device)

    def _build_product_graph(self) -> DynamicGraph:
        nfa = self._nfa
        n, src, dst, w, _ = product_graph(self.graph, nfa.delta, nfa.num_states)
        cap = self._product_capacity
        if cap is None:
            per = max((len(v) for v in nfa.delta.values()), default=1)
            cap = max(16, self.graph.capacity * per)
        return DynamicGraph(n, list(zip(src.tolist(), dst.tolist(), w.tolist())), capacity=cap)

    def _translate(self, updates) -> list[tuple[int, int, int, float, int]]:
        """Base-graph δE → product-graph δE (one edge per NFA transition)."""
        out = []
        k = self._nfa.num_states
        for (u, v, lbl, _w, sign) in updates:
            for (s, s2) in self._nfa.delta.get(int(lbl), ()):
                out.append((int(u) * k + s, int(v) * k + s2, 0, 1.0, int(sign)))
        return out

    # ------------------------------------------------------------ ingestion
    def _ingest(self, updates, engine_call):
        """Shared ingestion path: count, route pre-engine updates to the
        base graph, translate through the NFA when the family has one, then
        hand the batch to ``engine_call`` and enforce the budget."""
        updates = list(updates)
        self.updates_applied += len(updates)
        if self._impl is None:
            # no engine yet: updates land on the base graph, which the
            # engine build snapshots
            self.graph.apply_batch(updates)
            return None
        with obs_trace.span(
            "update_batch",
            "update_batch",
            pid="session",
            engine=self.engine_kind,
            num_updates=len(updates),
            queries=self.num_queries,
        ):
            if self._nfa is not None:
                self.graph.apply_batch(updates)
                updates = self._translate(updates)
                if not updates:
                    self._govern()
                    return self.last_stats
            out = engine_call(updates)
            self._govern()
        return out

    def apply_updates(self, updates):
        """Ingest one δE batch and maintain every registered query."""
        return self._ingest(updates, self._impl_apply)

    def _impl_apply(self, updates):
        return self._impl.apply_updates(updates)

    def apply_updates_batched(self, updates, batch_size: int | None = None):
        """Stream a δE log through the engine's batched path (the dense
        engine's fixed-shape chunks; host/scratch take it as one batch)."""
        return self._ingest(
            updates, lambda u: self._impl.apply_updates_batched(u, batch_size=batch_size)
        )

    # ------------------------------------------------------------------ api
    def answers(self, handle: QueryHandle) -> np.ndarray:
        """The query's final vertex states. [V] ([V·|S|] for RPQ plans —
        see :meth:`reachable`)."""
        return self._impl.answers_row(self._slot(handle))

    def reachable(self, handle: QueryHandle) -> np.ndarray:
        """RPQ answer extraction: bool [V_base] — which base vertices match."""
        plan = self._plans[handle.qid]
        if plan.nfa is None:
            raise ValueError("reachable() applies to RPQ plans")
        d = self.answers(handle).reshape(self.graph.num_vertices, plan.nfa.num_states)
        return np.isfinite(d[:, list(plan.nfa.accept)]).any(axis=-1)

    def aggregate(self, handle: QueryHandle) -> dict:
        """Evaluate the plan's Aggregate operator over the query's answers.

        Stateless post-processing: RPQ answers are first reduced to
        base-vertex space (min over the accepting NFA states).  ``topk``
        returns the k best finite values with their vertices; ``histogram``
        buckets the finite values into equal-width bins and counts the
        unreachable rest.
        """
        plan = self._plans[self._require_qid(handle)]
        node = plan.aggregate
        if node is None:
            raise ValueError("plan has no aggregate operator")
        vals = self.answers(handle)
        if plan.nfa is not None:
            vals = vals.reshape(self.graph.num_vertices, plan.nfa.num_states)[
                :, list(plan.nfa.accept)
            ].min(axis=1)
        finite = np.isfinite(vals)
        out = {"op": node.op_id, "agg": node.agg}
        if node.agg == "target":
            out["vertex"] = int(node.vertex)
            out["value"] = float(vals[int(node.vertex)])
            return out
        if node.agg == "topk":
            idx = np.nonzero(finite)[0]
            order = idx[np.argsort(vals[idx], kind="stable")][: node.k]
            out["vertices"] = [int(i) for i in order]
            out["values"] = [float(vals[i]) for i in order]
            return out
        if node.agg == "histogram":
            f = vals[finite]
            counts, edges = (
                np.histogram(f, bins=node.bins)
                if f.size
                else (np.zeros(node.bins, int), np.arange(node.bins + 1.0))
            )
            out["counts"] = [int(c) for c in counts]
            out["edges"] = [float(e) for e in edges]
            out["unreachable"] = int((~finite).sum())
            return out
        raise ValueError(f"unknown aggregate {node.agg!r}")

    def _public_qids(self) -> list[int]:
        return sorted(self._plans)

    def nbytes(self) -> int:
        return 0 if self._impl is None else self._impl.nbytes()

    def nbytes_per_query(self) -> list[int]:
        """Accounted bytes per registered query, aligned with
        :meth:`handles` (ascending qid) — the ``[Q]`` breakdown the memory
        governor meters."""
        per = self._nbytes_per_query_map()
        return [per[qid] for qid in self._public_qids()]

    def nbytes_per_operator(self) -> list[dict[str, int]]:
        """Per-query bytes refined to the operators owning difference
        stores, aligned with :meth:`handles`.  Every droppable operator of
        the plan graph appears (0 bytes when its store is dropped or the
        engine never materializes it)."""
        per = self._nbytes_per_op_map()
        return [{op: b for (q, op), b in per.items() if q == qid} for qid in self._public_qids()]

    def _nbytes_per_query_map(self) -> dict[int, int]:
        if self._impl is None:
            return {}
        by_slot = self._impl.nbytes_per_query()
        return {qid: by_slot.get(slot, 0) for qid, slot in self._handles.items()}

    def _per_op_map(self, by_slot: dict[int, dict[str, int]]) -> dict[tuple[int, str], int]:
        out: dict[tuple[int, str], int] = {}
        for qid, slot in self._handles.items():
            ops = dict(by_slot.get(slot, {"iterate": 0}))
            for op in self._plans[qid].droppable_ops():
                ops.setdefault(op, 0)  # e.g. a JOD engine's (empty) join op
            for op, n in ops.items():
                out[(qid, op)] = int(n)
        return out

    def _nbytes_per_op_map(self) -> dict[tuple[int, str], int]:
        """(qid, op_id) → accounted bytes — the governor's victim table."""
        return {} if self._impl is None else self._per_op_map(self._impl.nbytes_per_operator())

    def _recompute_cost_op_map(self) -> dict[tuple[int, str], int]:
        if self._impl is None:
            return {}
        return self._per_op_map(self._impl.recompute_cost_per_operator())

    # --------------------------------------------------------- drop policy
    def set_drop_policy(self, handle: QueryHandle, cfg: dr.DropConfig, op: str = "iterate") -> int:
        """Rewrite ONE operator's drop policy of a live query mid-stream
        (the governor's primitive, exposed for manual tuning).

        ``op="iterate"`` (default) is the §5 selection rewrite: the engine
        sheds stored diffs the new policy selects.  ``op="join"`` drops the
        query's join trace completely (an enabled config) or re-materializes
        it (a disabled one).  Returns the bytes released."""
        return self._set_op_drop_policy_qid(self._require_qid(handle), op, cfg)

    def _require_qid(self, handle: QueryHandle) -> int:
        if handle.qid in self._handles:
            return handle.qid
        raise ValueError(f"handle {handle.qid} is not registered")

    def _set_op_drop_policy_qid(self, qid: int, op: str, cfg: dr.DropConfig) -> int:
        if qid not in self._handles:
            raise ValueError(f"query {qid} is not registered")
        freed = self._impl.set_drop_params(self._handles[qid], cfg, op_id=op)
        plan = self._plans[qid]
        if any(n.op_id == op for n in plan.ops):
            self._plans[qid] = plan.with_op_drop(op, cfg)
        # else: the engine's implicit operator (e.g. a plan's join trace
        # under mode="vdc") — engine state changed, no plan node to annotate
        self.bytes_shed_total += max(int(freed), 0)
        return int(freed)

    def _det_overflow_shed(self) -> int:
        """DroppedVT records lost to Det-Drop evictions during sheds (the
        governor's escalation guard folds these in; sweep-time losses
        arrive via MaintainStats)."""
        return int(getattr(self._impl, "det_overflow_shed", 0))

    # ------------------------------------------------------------ governor
    @property
    def governor(self) -> MemoryGovernor | None:
        return self._governor

    @property
    def budget_bytes(self) -> int | None:
        return None if self._governor is None else self._governor.budget_bytes

    def _govern(self) -> None:
        if self._governor is None or self._impl is None or not self._handles:
            return
        self._governor.enforce(self)

    @property
    def num_queries(self) -> int:
        return len(self._plans)

    @property
    def last_stats(self):
        return getattr(self._impl, "last_stats", None)

    def publish_metrics(self, registry=None):
        """Scrape this session into the (default) obs metrics registry —
        gauges overwrite, counters advance (``repro_torch.obs.probes``).
        Returns the registry."""
        return publish_session_metrics(self, registry)

    def stats(self) -> dict:
        """Session/engine counters for serving telemetry."""
        out = {
            "engine": self.engine_kind,
            "active_queries": self.num_queries,
            "registered_total": self.registered_total,
            "deregistered_total": self.deregistered_total,
            "updates_applied": self.updates_applied,
            "bytes_freed_total": self.bytes_freed_total,
            "bytes_shed_total": self.bytes_shed_total,
            "nbytes": self.nbytes(),
            "nbytes_per_query": self.nbytes_per_query(),
            "nbytes_per_operator": self.nbytes_per_operator(),
            "query_qids": self._public_qids(),
        }
        if self._governor is not None:
            out["governor"] = self._governor.snapshot(self)
        if isinstance(self._impl, DenseEngine):
            out["slot_capacity"] = self._impl.impl.slot_capacity
            out["shards"] = 1
        ls = self.last_stats
        if isinstance(ls, MaintainStats):
            out["last_maintain"] = maintain_stats_dict(ls)
        return out

    # ------------------------------------------------------------ durability
    def checkpoint(self, directory: str, *, step: int | None = None, extra: dict | None = None) -> str:
        raise NotImplementedError(f"CQPSession.checkpoint is not ported yet: it comes with {DURABILITY}")

    @classmethod
    def restore(cls, directory: str, *, step: int | None = None, mesh=None) -> "CQPSession":
        raise NotImplementedError(f"CQPSession.restore is not ported yet: it comes with {DURABILITY}")
