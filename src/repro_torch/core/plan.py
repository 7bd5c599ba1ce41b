"""Declarative query plans — the IR between query classes and engines.

The paper's system is a *continuous query processor*: clients register and
deregister recursive queries against a dynamic graph over time, with the
memory optimizations (dropping, recomputation) tuned **per operator** of the
query's dataflow.  Following DBSP's split between a declarative circuit IR
and its incremental executor, a :class:`QueryPlan` is a validated DAG of
typed operator nodes (:mod:`repro_torch.core.dataflow`): ``Ingest → [Transform] →
[Join] → Iterate → [Aggregate]``, where each operator owns its own
difference store and :class:`~repro_torch.core.dropping.DropConfig`.  Any engine
implementing the session protocol (`core/session.py`) can register a plan:
the dense engine, the host pointer engine, or SCRATCH.

One plan is ONE query — one row of the dense engine's leading Q axis, one
difference index of the host engine.  Multi-source helpers return a list of
plans (one per source).

Two constructors:

* the **compatibility constructor** — ``QueryPlan(kind=..., semiring=...,
  init=..., max_iters=..., drop=..., nfa=...)`` — synthesizes the canonical
  operator graph from the legacy single-node fields (bit-identical answers
  and byte accounting to the pre-graph IR);
* ``QueryPlan.from_graph(kind, ops)`` — an explicit node tuple, validated
  (cycle detection, dangling references, node-count constraints) with the
  legacy accessor fields derived from the graph.

Plans in one session must share a **family**: the static shape of the
compiled sweep (semiring, iteration bound, PageRank weight derivation, NFA
— i.e. everything but per-query knobs like source, drop policies, and
aggregates).  :func:`dataflow.family_key` is that compatibility key, stable
under node listing order.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core import dataflow as df
from repro_torch.core import dropping as dr
from repro_torch.core import semiring as sr
from repro_torch.core.dataflow import NFA, Aggregate, InitSpec  # noqa: F401  (re-export)

INF = np.float32(np.inf)


def _semiring_eq(a: sr.Semiring, b: sr.Semiring) -> bool:
    """Structural semiring equality (msg callables compare by identity)."""
    return (a.name, a.reduce, a.identity, a.carry_prev, a.base, a.hop_cap) == (
        b.name,
        b.reduce,
        b.identity,
        b.carry_prev,
        b.base,
        b.hop_cap,
    )


# --------------------------------------------------------------------- provenance
@dataclasses.dataclass(frozen=True)
class Provenance:
    """One rewrite applied to a plan by the plan optimizer.

    Rewritten answers stay attributable: the plan records which rule fired,
    what the pre-rewrite kind was, and the rule's parameters as a sorted
    ``(name, value)`` tuple (values are JSON scalars).  Excluded from the
    family key — a rewrite is an execution strategy, not a new sweep shape.
    """

    rule: str
    original_kind: str = ""
    params: tuple[tuple[str, object], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "params", tuple(sorted((str(k), v) for k, v in self.params))
        )

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "original_kind": self.original_kind,
            "params": [[k, v] for k, v in self.params],
        }

    @staticmethod
    def from_dict(obj: dict) -> "Provenance":
        return Provenance(
            rule=str(obj["rule"]),
            original_kind=str(obj.get("original_kind", "")),
            params=tuple((str(k), v) for k, v in obj.get("params", [])),
        )


# --------------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One registered query: a validated DAG of operator nodes.

    ``ops`` is the graph (the source of truth); the legacy fields
    (``semiring``/``init``/``max_iters``/``drop``/``nfa``/…) are accessor
    mirrors synced from the graph nodes, kept as dataclass fields so the
    compatibility constructor and existing call sites keep working.  To
    change a node's drop policy use :meth:`with_op_drop` — a bare
    ``dataclasses.replace(plan, drop=...)`` is rejected because the graph
    would silently win.
    """

    kind: str  # "sssp" | "khop" | "wcc" | "pagerank" | "rpq" | free-form
    semiring: sr.Semiring | None = None
    init: InitSpec | None = None
    max_iters: int | None = None
    drop: dr.DropConfig | None = None
    nfa: NFA | None = None
    # PageRank: edge weights derive from out-degrees (alpha / outdeg)
    weight_from_degree: bool = False
    alpha: float = 0.85
    ops: tuple[df.OpNode, ...] | None = None
    # optimizer rewrite trail (oldest first); free knob like aggregates
    provenance: tuple[Provenance, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "provenance", tuple(self.provenance))
        if self.ops is None:
            if self.semiring is None or self.init is None or self.max_iters is None:
                raise ValueError(
                    "the compatibility constructor needs semiring, init and "
                    "max_iters (or pass an explicit operator graph via ops=)"
                )
            if self.drop is None:
                object.__setattr__(self, "drop", dr.DropConfig())
            object.__setattr__(
                self,
                "ops",
                df.canonical(
                    semiring=self.semiring,
                    init=self.init,
                    max_iters=int(self.max_iters),
                    drop=self.drop,
                    nfa=self.nfa,
                    weight_from_degree=self.weight_from_degree,
                    alpha=self.alpha,
                ),
            )
            return
        nodes = df.validate(self.ops)
        it = next(n for n in nodes.values() if n.kind == "iterate")
        join = next((n for n in nodes.values() if n.kind == "join"), None)
        tf = next((n for n in nodes.values() if n.kind == "transform"), None)
        derived = dict(
            semiring=it.semiring,
            init=it.init,
            max_iters=int(it.max_iters),
            drop=it.drop,
            nfa=None if join is None else join.nfa,
            weight_from_degree=tf is not None and tf.weight_from_degree,
            alpha=0.85 if tf is None else float(tf.alpha),
        )
        mismatched = []
        if self.semiring is not None and not _semiring_eq(
            self.semiring, derived["semiring"]
        ):
            mismatched.append("semiring")
        for name in ("init", "max_iters", "drop", "nfa"):
            given = getattr(self, name)
            if given is not None and given != derived[name]:
                mismatched.append(name)
        if self.weight_from_degree and not derived["weight_from_degree"]:
            mismatched.append("weight_from_degree")
        if self.alpha != 0.85 and self.alpha != derived["alpha"]:
            mismatched.append("alpha")
        if mismatched:
            raise ValueError(
                f"legacy fields {mismatched} disagree with the operator graph"
                " — the graph is the source of truth; use with_op_drop() /"
                " from_graph() instead of dataclasses.replace"
            )
        for name, val in derived.items():
            object.__setattr__(self, name, val)

    # ----------------------------------------------------------- constructors
    @staticmethod
    def from_graph(kind: str, ops, *, provenance=()) -> "QueryPlan":
        """Build a plan from an explicit (validated) operator-node tuple."""
        return QueryPlan(kind=kind, ops=tuple(ops), provenance=tuple(provenance))

    # ------------------------------------------------------------- graph api
    def node(self, op_id: str) -> df.OpNode:
        for n in self.ops:
            if n.op_id == op_id:
                return n
        raise KeyError(f"plan has no operator {op_id!r}")

    def op_ids(self) -> tuple[str, ...]:
        return tuple(n.op_id for n in self.ops)

    def op_of_kind(self, kind: str) -> df.OpNode | None:
        return next((n for n in self.ops if n.kind == kind), None)

    def droppable_ops(self) -> tuple[str, ...]:
        """Operators that own a difference store (governor-addressable)."""
        return tuple(
            n.op_id for n in self.ops if n.kind in df.DROPPABLE_OPS
        )

    @property
    def aggregate(self) -> Aggregate | None:
        return self.op_of_kind("aggregate")

    @property
    def join_drop(self) -> dr.DropConfig | None:
        join = self.op_of_kind("join")
        return None if join is None else join.drop

    def join_policy(self) -> str:
        """The Join operator's storage policy: ``"none"`` (no join node),
        ``"auto"`` (inherit the engine mode — legacy), ``"materialize"``
        (VDC trace) or ``"drop"`` (complete dropping, JOD §4)."""
        join = self.op_of_kind("join")
        if join is None:
            return "none"
        if join.drop is None:
            return "auto"
        return "drop" if join.drop.enabled() else "materialize"

    def with_op_drop(self, op_id: str, cfg: dr.DropConfig | None) -> "QueryPlan":
        """A copy with operator ``op_id``'s drop policy replaced (the
        session's primitive for mid-stream policy rewrites)."""
        node = self.node(op_id)
        if node.kind not in df.DROPPABLE_OPS:
            raise ValueError(
                f"operator {op_id!r} ({node.kind}) owns no difference store"
            )
        if node.kind == "iterate" and cfg is None:
            cfg = dr.DropConfig()
        new_ops = tuple(
            dataclasses.replace(n, drop=cfg) if n.op_id == op_id else n
            for n in self.ops
        )
        return QueryPlan(kind=self.kind, ops=new_ops, provenance=self.provenance)

    def with_aggregate(
        self,
        agg: str = "topk",
        *,
        k: int = 8,
        bins: int = 8,
        vertex: int | None = None,
    ) -> "QueryPlan":
        """A copy with an Aggregate node appended (or replaced)."""
        it = self.op_of_kind("iterate")
        node = Aggregate(
            inputs=(it.op_id,),
            agg=agg,
            k=int(k),
            bins=int(bins),
            vertex=None if vertex is None else int(vertex),
        )
        new_ops = tuple(n for n in self.ops if n.kind != "aggregate") + (node,)
        return QueryPlan(kind=self.kind, ops=new_ops, provenance=self.provenance)

    def with_provenance(self, prov: Provenance) -> "QueryPlan":
        """A copy with one more rewrite recorded on the trail."""
        return QueryPlan(
            kind=self.kind, ops=self.ops, provenance=self.provenance + (prov,)
        )

    # ---------------------------------------------------------------- family
    def family_key(self) -> tuple:
        """Static-compatibility key: plans sharing a session must agree on
        everything that shapes the compiled sweep (per-query knobs — source,
        drop selection, aggregates — stay free).  Stable under node listing
        order (``dataflow.family_key`` sorts node keys)."""
        return df.family_key(self.ops)

    def build_init(self, num_vertices: int) -> np.ndarray:
        """D_0 row over the engine's vertex space.

        With an NFA, ``num_vertices`` is the product-space count and the
        source maps to its (source, start-state) product id.
        """
        if self.nfa is not None and self.init.kind == "source":
            spec = dataclasses.replace(
                self.init,
                source=int(self.init.source) * self.nfa.num_states + self.nfa.start,
            )
            return spec.build(num_vertices)
        return self.init.build(num_vertices)

    # ------------------------------------------------------------------ JSON
    def to_json(self) -> dict:
        """JSON-able plan graph (``from_json`` round-trips it)."""
        out: dict = {
            "kind": self.kind,
            "nodes": [df.node_to_dict(n) for n in self.ops],
        }
        if self.provenance:
            out["provenance"] = [p.to_dict() for p in self.provenance]
        return out

    @staticmethod
    def from_json(obj: dict | str) -> "QueryPlan":
        if isinstance(obj, str):
            obj = json.loads(obj)
        return QueryPlan.from_graph(
            obj.get("kind", "custom"),
            tuple(df.node_from_dict(n) for n in obj["nodes"]),
            provenance=tuple(
                Provenance.from_dict(p) for p in obj.get("provenance", [])
            ),
        )


# --------------------------------------------------------------------------- builders
def sssp(
    source: int,
    *,
    max_iters: int = 64,
    drop: dr.DropConfig | None = None,
) -> QueryPlan:
    """Single-source shortest-distance field (Bellman-Ford IFE)."""
    return QueryPlan.from_graph(
        "sssp",
        df.canonical(
            semiring=sr.min_plus(),
            init=InitSpec(kind="source", source=int(source)),
            max_iters=int(max_iters),
            drop=drop,
        ),
    )


def spsp(
    source: int,
    target: int,
    *,
    max_iters: int = 64,
    drop: dr.DropConfig | None = None,
) -> QueryPlan:
    """Single-pair shortest path: an SSSP field read at one target vertex
    (``Aggregate(agg="target")``).  Family-compatible with :func:`sssp`
    plans of the same ``max_iters`` — the aggregate is a free knob — and the
    match pattern of the planner's landmark rewrite (§6.6)."""
    return QueryPlan.from_graph(
        "spsp",
        df.canonical(
            semiring=sr.min_plus(),
            init=InitSpec(kind="source", source=int(source)),
            max_iters=int(max_iters),
            drop=drop,
            aggregate=Aggregate(agg="target", vertex=int(target)),
        ),
    )


def khop(
    source: int,
    k: int = 5,
    *,
    drop: dr.DropConfig | None = None,
) -> QueryPlan:
    """Vertices within ≤ k hops of the source; iterations bounded by k."""
    return QueryPlan.from_graph(
        "khop",
        df.canonical(
            semiring=sr.min_hop(float(k)),
            init=InitSpec(kind="source", source=int(source)),
            max_iters=int(k),
            drop=drop,
        ),
    )


def wcc(
    *,
    max_iters: int = 128,
    drop: dr.DropConfig | None = None,
) -> QueryPlan:
    """Weakly connected components: min-label propagation (the caller's
    graph must carry both edge directions)."""
    return QueryPlan.from_graph(
        "wcc",
        df.canonical(
            semiring=sr.min_label(),
            init=InitSpec(kind="labels"),
            max_iters=int(max_iters),
            drop=drop,
        ),
    )


def pagerank(
    *,
    iters: int = 10,
    alpha: float = 0.85,
    drop: dr.DropConfig | None = None,
) -> QueryPlan:
    """Pregel-style PageRank, fixed ``iters`` rounds (paper §6.1.2): the
    canonical graph routes the ingest through a Transform node deriving
    edge weights from out-degrees (α / outdeg)."""
    return QueryPlan.from_graph(
        "pagerank",
        df.canonical(
            semiring=sr.pagerank(alpha),
            init=InitSpec(kind="constant", fill=1.0),
            max_iters=int(iters),
            drop=drop,
            weight_from_degree=True,
            alpha=float(alpha),
        ),
    )


def rpq(
    source: int,
    nfa: NFA,
    *,
    max_iters: int = 64,
    drop: dr.DropConfig | None = None,
    join_store: str = "auto",
) -> QueryPlan:
    """Regular path query: reachability on the NFA-product graph.

    The canonical graph is ``Ingest → Join(nfa) → Iterate``: the session
    reads the Join node to own the product construction, so the engines
    never see automata; ``init.source`` is stored in *base* space and mapped
    to (source, start-state) at registration.

    ``join_store`` is the Join operator's own storage policy:

    * ``"auto"``        — inherit the engine mode (legacy behavior);
    * ``"materialize"`` — keep the per-edge message trace (VDC on the
      product graph);
    * ``"drop"``        — complete dropping (§4): the trace is never stored,
      messages recompute on demand ("drop the Join's differences, keep the
      Iterate's").
    """
    if join_store not in ("auto", "materialize", "drop"):
        raise ValueError(
            f"unknown join_store {join_store!r}; "
            "choose auto | materialize | drop"
        )
    join_drop = {
        "auto": None,
        "materialize": dr.DropConfig(),
        "drop": dr.DropConfig(mode="det", selection="random", p=1.0),
    }[join_store]
    return QueryPlan.from_graph(
        "rpq",
        df.canonical(
            semiring=sr.min_hop(),
            init=InitSpec(kind="source", source=int(source)),
            max_iters=int(max_iters),
            drop=drop,
            nfa=nfa,
            join_drop=join_drop,
        ),
    )
