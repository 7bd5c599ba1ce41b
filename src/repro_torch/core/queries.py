"""Query classes from the paper (§6.1.2) — thin builders over the plan IR.

Each query family is a :mod:`repro_torch.core.plan` builder; the functions
here assemble a *batch* of plans and stand up the dense engine for them (the
fixed-batch API: the query set is fixed at construction).

SPSP/SSSP/K-hop are *continuous registered queries* (Q of them batched in the
leading axis); WCC and PageRank are single batch computations (Q=1).  Every
builder takes ``device`` (default: the CUDA device; ``"cpu"`` runs the plain
PyTorch versions).  :class:`RPQ` wraps a session, which owns the
product-graph translation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import dropping as dr
from repro_torch.core import plan as qplan
from repro_torch.core.engine import DiffIFE
from repro_torch.core.graph import DynamicGraph
from repro_torch.core.plan import NFA
from repro_torch.core.session import CQPSession, engine_config_for


def engine_from_plans(
    graph: DynamicGraph,
    plans: Sequence[qplan.QueryPlan],
    *,
    batch_capacity: int = 32,
    mesh=None,
    mode: str = "jod",
    drop: dr.DropConfig | None = None,
    store_capacity: int = 16,
    jstore_capacity: int = 8,
    backend: str = "coo",
    device=None,
) -> DiffIFE:
    """Dense engine for a fixed batch of same-family plans (Q slots, all
    active, no padding).  ``drop`` is the session-level DroppedVT
    representation; each plan's own ``drop`` supplies its per-query
    selection row.  A plan whose Join materializes its trace makes the
    engine VDC (``mode="vdc"`` asks for it too); each plan's Join policy
    then sets its slot's ``join_mat`` flag."""
    first = plans[0]
    for p in plans[1:]:
        if p.family_key() != first.family_key():
            raise ValueError(
                "plans in one engine batch must share a family "
                f"({p.family_key()} vs {first.family_key()})"
            )
    spec = drop or next((p.drop for p in plans if p.drop.enabled()), dr.DropConfig())
    for p in plans:
        if p.drop.enabled() and p.drop.mode != spec.mode:
            raise ValueError(
                f"plan drop mode {p.drop.mode!r} does not match the "
                f"engine's DroppedVT representation {spec.mode!r}"
            )
    # a plan whose Join node materializes its trace needs the VDC join store
    if any(p.join_policy() == "materialize" for p in plans):
        mode = "vdc"
    v = graph.num_vertices
    cfg = engine_config_for(
        first,
        num_queries=len(plans),
        num_vertices=v,
        mode=mode,
        drop=spec,
        store_capacity=store_capacity,
        jstore_capacity=jstore_capacity,
        backend=backend,
    )
    init = np.stack([p.build_init(v) for p in plans])
    return DiffIFE(
        cfg,
        graph,
        init,
        batch_capacity=batch_capacity,
        mesh=mesh,
        drop_rows=[p.drop for p in plans],
        join_rows=[p.join_policy() != "drop" for p in plans],
        device=device,
    )


# --------------------------------------------------------------------------- SSSP / SPSP
def sssp(
    graph: DynamicGraph,
    sources: Sequence[int],
    *,
    max_iters: int = 64,
    batch_capacity: int = 32,
    mesh=None,
    drop: dr.DropConfig | None = None,
    **kw,
) -> DiffIFE:
    """Q concurrent single-source shortest-distance fields (Bellman-Ford IFE)."""
    plans = [qplan.sssp(int(s), max_iters=max_iters, drop=drop) for s in sources]
    return engine_from_plans(
        graph, plans, batch_capacity=batch_capacity, mesh=mesh, drop=drop, **kw
    )


def spsp_answers(engine: DiffIFE, targets: Sequence[int]) -> np.ndarray:
    """SPSP = SSSP field read at the target (paper's query form)."""
    d = engine.answers()
    return np.asarray([d[q, int(t)] for q, t in enumerate(targets)], np.float32)


# --------------------------------------------------------------------------- K-hop
def khop(
    graph: DynamicGraph,
    sources: Sequence[int],
    k: int = 5,
    *,
    batch_capacity: int = 32,
    mesh=None,
    drop: dr.DropConfig | None = None,
    **kw,
) -> DiffIFE:
    """Vertices within ≤ k hops of each source; iterations bounded by k."""
    plans = [qplan.khop(int(s), k=int(k), drop=drop) for s in sources]
    return engine_from_plans(
        graph, plans, batch_capacity=batch_capacity, mesh=mesh, drop=drop, **kw
    )


def khop_reachable(engine: DiffIFE) -> np.ndarray:
    return np.isfinite(engine.answers())


# --------------------------------------------------------------------------- WCC
def wcc(
    graph: DynamicGraph,
    *,
    max_iters: int = 128,
    batch_capacity: int = 32,
    mesh=None,
    drop: dr.DropConfig | None = None,
    **kw,
) -> DiffIFE:
    """Weakly connected components: min-label propagation on the symmetrized
    graph (caller supplies a graph with both edge directions)."""
    plans = [qplan.wcc(max_iters=max_iters, drop=drop)]
    return engine_from_plans(
        graph, plans, batch_capacity=batch_capacity, mesh=mesh, drop=drop, **kw
    )


# --------------------------------------------------------------------------- PageRank
def pagerank(
    graph: DynamicGraph,
    *,
    iters: int = 10,
    alpha: float = 0.85,
    batch_capacity: int = 32,
    mesh=None,
    drop: dr.DropConfig | None = None,
    **kw,
) -> DiffIFE:
    """Pregel-style PageRank, fixed ``iters`` rounds (paper §6.1.2)."""
    plans = [qplan.pagerank(iters=iters, alpha=alpha, drop=drop)]
    return engine_from_plans(
        graph, plans, batch_capacity=batch_capacity, mesh=mesh, drop=drop, **kw
    )


# --------------------------------------------------------------------------- RPQ
class RPQ:
    """Continuous RPQ evaluation via Diff-IFE on the NFA-product graph.

    A wrapper over :class:`~repro_torch.core.session.CQPSession`: the
    session owns the product-graph construction and translates base-graph
    updates into product updates (one product edge per matching NFA
    transition); the engine maintains reachability (min-hop semiring) from
    (source, start).
    """

    def __init__(
        self,
        graph: DynamicGraph,
        nfa: NFA,
        sources: Sequence[int],
        *,
        max_iters: int = 64,
        product_capacity: int | None = None,
        batch_capacity: int = 32,
        drop: dr.DropConfig | None = None,
        join_store: str = "auto",
        **kw,
    ) -> None:
        self.base = graph
        self.nfa = nfa
        self.sources = [int(s) for s in sources]
        self.session = CQPSession(
            graph,
            engine="dense",
            batch_capacity=batch_capacity,
            product_capacity=product_capacity,
            min_slots=len(self.sources),
            drop=drop,
            **kw,
        )
        self.handles = self.session.register_many(
            [
                qplan.rpq(s, nfa, max_iters=max_iters, drop=drop, join_store=join_store)
                for s in self.sources
            ]
        )

    @property
    def pgraph(self) -> DynamicGraph:
        return self.session._egraph

    @property
    def engine(self) -> DiffIFE:
        return self.session._impl.impl

    def _translate(self, updates) -> list[tuple[int, int, int, float, int]]:
        return self.session._translate(updates)

    def apply_updates(self, updates):
        return self.session.apply_updates(updates)

    def reachable(self) -> np.ndarray:
        """bool [Q, V_base]: which base vertices match the RPQ per source."""
        return np.stack([self.session.reachable(h) for h in self.handles])

    def nbytes(self) -> int:
        return self.session.nbytes()
