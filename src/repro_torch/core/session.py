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

With ``optimize="auto"|"always"`` the plan optimizer
(:mod:`repro_torch.planner`) rewrites matching plans at registration: SPSP
plans share one landmark index whose forward fields are *internal* engine
rows of this session and whose reverse fields live in a twin session over
Gᵀ, and answer through pruned-scratch subqueries.

``checkpoint``/``restore`` write and read the reference's checkpoint
format (``checkpoint/store.py``), planner state included: a session
checkpointed by either package restores in the other, at any shard count.

``mesh=`` (a :class:`~repro_torch.launch.mesh.DataMesh`, or a
:class:`~repro_torch.launch.mesh.Mesh` whose ``data`` axis it takes; dense engine only)
runs the vertex-sharded sweep: every slot-pool call acts on every shard's
rows, and ``restore(mesh=)`` places a checkpoint taken at any shard count
onto the current mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import dropping as dr
from repro_torch.core import plan as qp
from repro_torch.core.engine import DiffIFE, EngineConfig, MaintainStats, resolve_device
from repro_torch.core.governor import GovernorConfig, MemoryGovernor
from repro_torch.core.graph import DynamicGraph, product_graph
from repro_torch.core.scratch import ScratchEngine
from repro_torch.core.sparse_engine import SparseDiffIFE
from repro_torch.launch.mesh import DataMesh, as_data_mesh, mesh_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.probes import maintain_stats_dict, publish_session_metrics

ENGINES = ("dense", "host", "scratch")

# session checkpoint manifest-meta layout version (the reference's)
CHECKPOINT_FORMAT = 1

# the reference's Pallas-only session knobs: the port writes them into a
# checkpoint's meta with the reference's defaults and accepts them back
REFERENCE_KW = {"ell_block_v": 128, "interpret": None}


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


def _session_device(mesh, device) -> torch.device:
    """A session's device: the mesh's first, or ``device`` (None: CUDA)."""
    return resolve_device(device) if mesh is None else mesh_device(mesh, device)


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
        mesh: DataMesh | None = None,
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
            mesh=mesh, device=device,
        )

    def _join_flag(self, plan: qp.QueryPlan) -> bool | None:
        """The plan's Join materialization flag for the engine slot; a plan
        that materializes its Join needs an engine with a join store."""
        policy = plan.join_policy()
        if policy == "materialize" and self.impl.states[0].jstore is None:
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
        if mesh is not None and engine != "dense":
            raise ValueError("mesh sharding is a dense-engine feature")
        if governor is not None and budget_bytes is None:
            raise ValueError("a GovernorConfig needs budget_bytes to enforce")
        self.device = _session_device(mesh, device)
        self.mesh = None if mesh is None else as_data_mesh(mesh)  # vertices over `data` alone
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
        self._runtime: dict = {}  # serving-runtime observers (stats()["runtime"])
        self.restore_info: dict | None = None  # set by CQPSession.restore
        # plan optimizer (repro_torch.planner): rewrites matching plans at
        # registration; qids it owns answer through rule-owned runtimes, and
        # qids it registers for shared subplans are *internal* — excluded
        # from every public per-query view but governor-addressable
        self._optimize = optimize
        self._planner = None
        self._internal: set[int] = set()
        self._governing = False  # re-entrancy guard (remat registers inside enforce)
        if optimize != "none":
            self._ensure_planner()
        # lifetime counters (stats())
        self.registered_total = 0
        self.deregistered_total = 0
        self.updates_applied = 0
        self.bytes_freed_total = 0
        self.bytes_shed_total = 0  # reclaimed by drop-policy rewrites

    # ------------------------------------------------------------ lifecycle
    def register(self, plan: qp.QueryPlan, *, optimize: str | None = None) -> QueryHandle:
        """Register one query; its trace is computed in-engine (mid-stream
        registration converges to the same answers as from-start).

        ``optimize`` overrides the session's optimizer mode for this call
        (``"none"`` | ``"auto"`` | ``"always"`` — see `repro_torch.planner`)."""
        return self.register_many([plan], optimize=optimize)[0]

    def _ensure_planner(self):
        if self._planner is None:
            from repro_torch.planner.rules import Planner

            self._planner = Planner(self, self._optimize if self._optimize != "none" else "auto")
        return self._planner

    def register_many(
        self, plans: list[qp.QueryPlan], *, optimize: str | None = None
    ) -> list[QueryHandle]:
        """Register a batch of queries — the dense engine computes all of
        their traces in ONE maintenance sweep.

        Atomic: a rejected batch (family mismatch, drop-mode conflict, an
        engine that cannot run the family) leaves the session exactly as it
        was, including across the deferred first engine build.

        With the plan optimizer active (session ``optimize=`` or the
        per-call override), each plan first runs through the rewrite rules:
        matches that pay are admitted to the owning rule's shared runtime
        instead of an engine slot, and their handles carry the rewritten
        (provenance-stamped) plan.
        """
        if not plans:
            return []
        plans = list(plans)
        mode = self._optimize if optimize is None else optimize
        if mode not in ("none", "auto", "always"):
            raise ValueError(f"unknown optimize mode {mode!r}; choose none | auto | always")
        # validate the WHOLE batch before committing any session state
        self._check_batch(plans)
        rules: dict[int, object] = {}
        if mode != "none":
            planner = self._ensure_planner()
            for i, plan in enumerate(plans):
                rule = planner.consider(plan, mode)
                if rule is not None:
                    rules[i] = rule
        handles: list[QueryHandle | None] = [None] * len(plans)
        engine_idx = [i for i in range(len(plans)) if i not in rules]
        if engine_idx:
            qids = self._register_engine_plans([plans[i] for i in engine_idx])
            for i, qid in zip(engine_idx, qids):
                handles[i] = QueryHandle(qid=qid, plan=self._plans[qid])
        for i in sorted(rules):
            qid = self._next_qid
            self._next_qid += 1
            new_plan = self._planner.admit(qid, plans[i], rules[i])
            self._plans[qid] = new_plan
            self.registered_total += 1
            handles[i] = QueryHandle(qid=qid, plan=new_plan)
        self._govern()
        return handles

    def _check_batch(self, plans: list[qp.QueryPlan]) -> tuple:
        """Validate a batch against the session family and DroppedVT
        representation (pure); returns the family key."""
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
        return base

    def _register_engine_plans(self, plans: list[qp.QueryPlan], *, internal: bool = False) -> list[int]:
        """The engine-slot registration path: validate the whole batch,
        commit the family, build the engine on first use, unwind on any
        failure.  ``internal=True`` registers planner-owned subplan rows:
        full engine and governor citizens, excluded from the public
        per-query views and the ``registered_total`` counter."""
        base = self._check_batch(plans)
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
            if internal:
                self._internal.add(qid)
            else:
                self.registered_total += 1
            if self._governor is not None:
                self._governor.on_register(qid, plan)
            qids.append(qid)
        return qids

    def _register_internal(self, plans: list[qp.QueryPlan]) -> list[int]:
        """Planner hook: register shared-subplan rows (e.g. the landmark
        index's SSSP fields) as internal engine queries."""
        return self._register_engine_plans(plans, internal=True)

    def _deregister_internal(self, qids) -> int:
        """Planner hook: retire internal subplan rows; returns bytes freed."""
        freed = 0
        for qid in list(qids):
            slot = self._handles.pop(qid)
            freed += self._impl.deregister_plan(slot)
            del self._plans[qid]
            self._internal.discard(qid)
            if self._governor is not None:
                self._governor.on_deregister(qid)
        return freed

    def deregister(self, handle: QueryHandle) -> int:
        """Retire a query: its difference rows are emptied and the accounted
        bytes released are returned; the slot returns to the free pool.
        A planner-owned query releases through its rule (the shared index
        tears down with its last sharer)."""
        if handle.qid in self._internal:
            raise ValueError("internal planner subqueries retire with their shared state")
        if self._planner is not None and self._planner.owns(handle.qid):
            freed = self._planner.release(handle.qid)
            del self._plans[handle.qid]
            self.deregistered_total += 1
            self.bytes_freed_total += freed
            self._govern()
            return freed
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
                self._egraph, first_plan, drop_spec=self._drop_spec, mesh=self.mesh,
                device=self.device, **kw
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
        base_updates = updates  # pre-NFA δE, for the planner's twin feeds
        self.updates_applied += len(updates)
        if self._impl is None:
            # no engine yet: updates land on the base graph, which the
            # engine build snapshots
            self.graph.apply_batch(updates)
            if self._planner is not None:
                self._planner.on_updates(base_updates)
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
            if self._planner is not None:
                # engine maintenance (the internal index rows included) ran:
                # rules now refresh their rewritten queries' runtimes
                self._planner.on_updates(base_updates)
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
        see :meth:`reachable`).  Planner-rewritten queries answer through
        their owning rule's runtime (e.g. the landmark pruned-scratch
        subquery — exact at the plan's target vertex)."""
        if self._planner is not None and self._planner.owns(handle.qid):
            return self._planner.answers(handle.qid)
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
        """Ascending qids of client-registered queries (planner-internal
        subplan rows excluded)."""
        return [q for q in sorted(self._plans) if q not in self._internal]

    def handles(self) -> list[QueryHandle]:
        return [QueryHandle(qid=q, plan=self._plans[q]) for q in self._public_qids()]

    def answers_snapshot(self) -> dict[int, np.ndarray]:
        """qid → an owned host copy of every registered query's answers.

        The serving tier's epoch view: taken between chunk applies, the
        copies stay immutable while the next chunk folds in on another
        thread (and while the engine edits its device state in place), so
        concurrent readers never observe a half-applied δE chunk.  Every
        engine's ``answers_row`` returns such a copy (the dense engine's a
        synchronous device → host copy)."""
        out: dict[int, np.ndarray] = {}
        if self._impl is not None:
            out = {
                qid: self._impl.answers_row(slot)
                for qid, slot in self._handles.items()
                if qid not in self._internal
            }
        if self._planner is not None:
            out.update(self._planner.answers_snapshot())
        return out

    def nbytes(self) -> int:
        total = 0 if self._impl is None else self._impl.nbytes()
        if self._planner is not None:
            total += self._planner.extra_nbytes()
        return total

    def nbytes_per_query(self) -> list[int]:
        """Accounted bytes per registered query, aligned with
        :meth:`handles` (ascending qid) — the ``[Q]`` breakdown the memory
        governor meters.  Planner-rewritten queries read 0 here: their
        shared state is accounted under the internal index rows and the
        ``(PLANNER_QID, op)`` pseudo-operator."""
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
        out: dict[int, int] = {}
        if self._impl is not None:
            by_slot = self._impl.nbytes_per_query()
            out = {qid: by_slot.get(slot, 0) for qid, slot in self._handles.items()}
        if self._planner is not None:
            out.update({qid: 0 for qid in self._planner.owned})
        return out

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
        """(qid, op_id) → accounted bytes — the governor's victim table.
        Internal subplan rows appear under their own qids; rule-owned
        shared state adds ``(PLANNER_QID, op)`` pseudo-rows."""
        out = {} if self._impl is None else self._per_op_map(self._impl.nbytes_per_operator())
        if self._planner is not None:
            out.update(self._planner.pseudo_ops())
        return out

    def _recompute_cost_op_map(self) -> dict[tuple[int, str], int]:
        out = {} if self._impl is None else self._per_op_map(self._impl.recompute_cost_per_operator())
        if self._planner is not None:
            out.update(self._planner.pseudo_costs())
        return out

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
        if self._planner is not None and self._planner.owns(handle.qid):
            return handle.qid
        raise ValueError(f"handle {handle.qid} is not registered")

    def _set_op_drop_policy_qid(self, qid: int, op: str, cfg: dr.DropConfig) -> int:
        if qid < 0:
            # governor rung for planner-owned shared state: an enabled config
            # sheds it (landmark de-materialization), a disabled one
            # re-materializes it — routed to the rule owning the pseudo-op
            freed = self._ensure_planner().set_pseudo_policy(op, cfg)
            self.bytes_shed_total += max(int(freed), 0)
            return int(freed)
        if qid not in self._handles:
            if self._planner is not None and self._planner.owns(qid):
                raise ValueError(
                    f"query {qid} answers through a planner rewrite and owns no "
                    "engine difference store; its shared state is governed as a "
                    "(PLANNER_QID, op) pseudo-operator"
                )
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
        if self._governor is None or self._impl is None or self._governing:
            return
        if not self._handles and (self._planner is None or not self._planner.owned):
            return
        # the guard makes enforcement non-reentrant: a de-escalation that
        # re-materializes a planner index registers internal plans, and that
        # path must not recurse into enforce()
        self._governing = True
        try:
            self._governor.enforce(self)
        finally:
            self._governing = False

    @property
    def num_queries(self) -> int:
        return len(self._plans) - len(self._internal)

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
        if self._planner is not None:
            out["planner"] = self._planner.snapshot()
        if isinstance(self._impl, DenseEngine):
            out["slot_capacity"] = self._impl.impl.slot_capacity
            out["shards"] = self._impl.impl.num_shards
        ls = self.last_stats
        if isinstance(ls, MaintainStats):
            out["last_maintain"] = maintain_stats_dict(ls)
        if self._runtime:
            rt: dict = {}
            det = self._runtime.get("straggler")
            if det is not None:
                rt["straggler"] = {
                    "observed": det.seen,
                    "ewma_s": det.ewma,
                    "events": [dataclasses.asdict(e) for e in det.events],
                }
            sup = self._runtime.get("supervisor")
            if sup is not None:
                rt["fault"] = sup.metrics()
            out["runtime"] = rt
        return out

    @property
    def num_shards(self) -> int:
        if isinstance(self._impl, DenseEngine):
            return self._impl.impl.num_shards
        return 1 if self.mesh is None else self.mesh.size

    def nbytes_per_device(self) -> list[int]:
        """Accounted bytes per shard of the dense engine's vertex partition
        (they sum to :meth:`nbytes`'s engine part; one entry unsharded)."""
        if isinstance(self._impl, DenseEngine) and self._impl.impl.sharded:
            return self._impl.impl.nbytes_per_device()
        return [self.nbytes()]

    # ------------------------------------------------------------ durability
    def attach_runtime(self, *, straggler=None, supervisor=None) -> None:
        """Register serving-runtime observers; they surface in
        ``stats()["runtime"]`` (straggler events / recovery metrics)."""
        if straggler is not None:
            self._runtime["straggler"] = straggler
        if supervisor is not None:
            self._runtime["supervisor"] = supervisor

    def _meta_kw(self) -> dict:
        """The session knobs in the reference's meta layout (its 8 keys, in
        its order); the device is never written."""
        kw = {k: self._kw[k] for k in ("mode", "backend", "store_capacity", "jstore_capacity")}
        kw.update(REFERENCE_KW)
        kw.update(batch_capacity=self._kw["batch_capacity"], min_slots=self._kw["min_slots"])
        return kw

    def state_dict(self, *, extra: dict | None = None) -> tuple[dict, dict]:
        """(arrays, meta): everything needed to rebuild this session.

        Arrays are host copies of the graph(s) and the engine's difference
        trace (synchronous device → host copies, so no later in-place edit
        reaches them); meta (JSON-able, rides in the checkpoint manifest)
        carries plans, handle table, qid cursor, counters, drop/governor
        state and ``extra`` (the caller's update-log cursor).  Host
        adjacency, init rows and device views are recomputed at restore.
        """
        arrays: dict[str, np.ndarray] = {}
        g_arrays, g_meta = self.graph.state_dict()
        arrays.update({f"graph/{k}": v for k, v in g_arrays.items()})
        c = {
            "registered_total": self.registered_total,
            "deregistered_total": self.deregistered_total,
            "updates_applied": self.updates_applied,
            "bytes_freed_total": self.bytes_freed_total,
            "bytes_shed_total": self.bytes_shed_total,
        }
        meta: dict = {
            "format": CHECKPOINT_FORMAT,
            "engine": self.engine_kind,
            "kw": self._meta_kw(),
            "drop_spec": None if self._drop_spec is None else dataclasses.asdict(self._drop_spec),
            "product_capacity": self._product_capacity,
            "graph": g_meta,
            "egraph": None,
            "family_plan": None,
            "plans": {str(q): p.to_json() for q, p in self._plans.items()},
            "handles": {str(q): int(s) for q, s in self._handles.items()},
            "next_qid": self._next_qid,
            "counters": c,
            "engine_state": self._impl is not None,
            "engine_meta": None,
            "governor": None,
            "optimize": self._optimize,
            "internal": sorted(self._internal),
            "planner": None,
            "user": extra,
        }
        if self._planner is not None:
            p_arrays, p_meta = self._planner.state_dict()
            arrays.update(p_arrays)
            meta["planner"] = p_meta
        if self._impl is not None:
            meta["family_plan"] = self._family_plan.to_json()
            if self._nfa is not None:
                e_arrays, e_meta = self._egraph.state_dict()
                arrays.update({f"egraph/{k}": v for k, v in e_arrays.items()})
                meta["egraph"] = e_meta
            impl = self._impl.impl if isinstance(self._impl, DenseEngine) else self._impl
            en_arrays, en_meta = impl.export_state()
            arrays.update({f"engine/{k}": v for k, v in en_arrays.items()})
            meta["engine_meta"] = en_meta
        if self._governor is not None:
            meta["governor"] = self._governor.state_dict()
        return arrays, meta

    def checkpoint(self, directory: str, *, step: int | None = None, extra: dict | None = None) -> str:
        """Synchronous atomic snapshot into ``directory``; returns the step
        dir.  ``step`` defaults to the cumulative ingested-update count; pass
        ``extra`` for the serving loop's log cursor.  (The recovery
        supervisor drives the async keep-N path through
        :class:`~repro_torch.checkpoint.CheckpointManager` instead.)"""
        arrays, meta = self.state_dict(extra=extra)
        step = self.updates_applied if step is None else int(step)
        return ckpt_store.save_checkpoint(directory, step, arrays, meta=meta)

    @classmethod
    def restore(cls, directory: str, *, step: int | None = None, mesh=None, device=None) -> "CQPSession":
        """Rebuild a session from the latest (or ``step``'s) checkpoint, of
        this package or the reference, on ``device`` (``None``: the CUDA
        device).

        Replaying the same update-log suffix then yields answers
        bit-identical to an uninterrupted run (min-family semirings).
        ``session.restore_info`` carries the restored step, the saver's
        ``extra`` cursor and ``timings``: seconds spent loading the
        checkpoint, rebuilding the graph(s), building the engine (its device
        graph and, on ``ell``/``fused``, the host ELL view) and importing the
        saved state.  ``mesh`` is the *current* mesh: the saved state is
        global, and the engine's ``import_state`` moves the J rows into this
        mesh's cells and splits every leaf over its shards, so a checkpoint
        taken at any shard count restores at any other; the device is then
        the mesh's.
        """
        device = _session_device(mesh, device)
        t0 = time.perf_counter()
        arrays, manifest, step = ckpt_store.load_checkpoint(directory, step)
        timings = {"load_s": time.perf_counter() - t0}
        meta = manifest.get("meta")
        if meta is None:
            raise ValueError(
                f"checkpoint in {directory} carries no session meta — was it "
                "written by CQPSession.checkpoint / the recovery supervisor?"
            )
        sess = cls._from_state(arrays, meta, mesh=mesh, device=device, timings=timings)
        sess.restore_info = {"step": step, "extra": meta.get("user"), "timings": timings}
        return sess

    @classmethod
    def _from_state(cls, arrays: dict, meta: dict, *, mesh=None, device=None,
                    timings: dict | None = None) -> "CQPSession":
        """Rebuild a session from ``state_dict`` output (of either package);
        ``timings``, when given, receives the phase seconds (see
        :meth:`restore`)."""
        if int(meta.get("format", 0)) != CHECKPOINT_FORMAT:
            raise ValueError(f"unsupported session checkpoint format {meta.get('format')!r}")
        timings = {} if timings is None else timings
        device = _session_device(mesh, device)

        def clock() -> float:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter()

        def sub(prefix: str) -> dict:
            return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

        kw = dict(meta["kw"])
        for key, default in REFERENCE_KW.items():
            val = kw.pop(key, default)
            ok = (isinstance(val, int) and not isinstance(val, bool) and val >= 1) if key == "ell_block_v" \
                else val is None or isinstance(val, bool)
            if not ok:
                raise ValueError(f"checkpoint meta kw {key}={val!r} is not a valid reference setting")
        t = clock()
        graph = DynamicGraph.from_state(meta["graph"], sub("graph/"))
        drop = None if meta["drop_spec"] is None else dr.DropConfig(**meta["drop_spec"])
        gov = meta["governor"]
        gcfg = None
        if gov is not None:
            cfg_d = dict(gov["cfg"])
            cfg_d["ladder_p"] = tuple(cfg_d["ladder_p"])
            gcfg = GovernorConfig(**cfg_d)
        sess = cls(
            graph,
            engine=meta["engine"],
            drop=drop,
            product_capacity=meta["product_capacity"],
            budget_bytes=None if gov is None else int(gov["budget_bytes"]),
            governor=gcfg,
            optimize=meta.get("optimize", "none"),
            mesh=mesh,
            device=device,
            **kw,
        )
        sess._plans = {int(q): qp.QueryPlan.from_json(p) for q, p in meta["plans"].items()}
        sess._handles = {int(q): int(s) for q, s in meta["handles"].items()}
        sess._next_qid = int(meta["next_qid"])
        for name, val in meta["counters"].items():
            setattr(sess, name, int(val))
        if meta["engine_state"]:
            first = qp.QueryPlan.from_json(meta["family_plan"])
            sess._family_plan = first
            sess._family = first.family_key()
            sess._nfa = first.nfa
            if meta["egraph"] is not None:
                sess._egraph = DynamicGraph.from_state(meta["egraph"], sub("egraph/"))
            else:
                sess._egraph = graph
            timings["graph_s"] = clock() - t
            em = meta["engine_meta"]
            en_arrays = sub("engine/")
            t = clock()
            if sess.engine_kind == "dense":
                if sess._drop_spec is None:
                    sess._drop_spec = first.drop
                ekw = dict(sess._kw)
                # the saved pool size is a power of two, so min_slots =
                # slot_capacity rebuilds the exact pool (and with it the saved
                # free list's meaning); an all-inactive pool skips the
                # constructor sweep, so import lands on untouched state
                ekw["min_slots"] = int(em["slot_capacity"])
                ekw["mode"] = em["mode"]
                eng = DenseEngine(sess._egraph, first, drop_spec=sess._drop_spec, mesh=mesh,
                                  device=device, **ekw)
                timings["engine_s"] = clock() - t
                t = clock()
                eng.impl.import_state(en_arrays, em)
                sess._impl = eng
            elif sess.engine_kind == "host":
                imp = SparseDiffIFE(sess._egraph, max_iters=int(first.max_iters))
                timings["engine_s"] = clock() - t
                t = clock()
                imp.import_state(en_arrays, em)
                sess._impl = imp
            else:
                cfg = engine_config_for(
                    first,
                    num_queries=1,
                    num_vertices=sess._egraph.num_vertices,
                    backend=sess._kw["backend"],
                )
                imp = ScratchEngine(cfg, sess._egraph, device=device)
                timings["engine_s"] = clock() - t
                t = clock()
                imp.import_state(en_arrays, em)
                sess._impl = imp
            timings["import_s"] = clock() - t
        elif sess._handles:
            # engine handles exist only if an engine did: corrupt meta
            raise ValueError("checkpoint has live plans but no engine state")
        else:
            timings["graph_s"] = clock() - t
        if gov is not None:
            sess._governor.load_state(gov)
        sess._internal = {int(q) for q in meta.get("internal", [])}
        pm = meta.get("planner")
        if pm is not None:
            sess._ensure_planner().load_state(pm, arrays)
        return sess
