"""Operator-graph plan IR — typed dataflow nodes with per-operator stores.

The paper's optimizations are defined over the differences *of operators* in
a recursive dataflow: JOD (§4) drops the Join operator's difference trace
completely and recomputes it on demand; partial dropping (§5) thins the
Iterate operator's trace under a selection policy.  DBSP shows that an
explicit operator-circuit IR is the right substrate for incremental
maintenance, so a :class:`~repro_torch.core.plan.QueryPlan` is a validated DAG of
the node types below — **each operator owns its own difference store and
drop policy**:

    ``Ingest``     edge deltas entering the dataflow (δE); stateless — the
                   dynamic graph itself is session state, not differences.
    ``Transform``  per-edge weight/label maps (PageRank's α/outdeg
                   derivation); stateless, recomputed per sweep.
    ``Join``       product-graph construction for RPQs (base edges ⋈ NFA
                   transitions) *and* the materialized join trace inside the
                   fixed point: ``drop=None`` inherits the engine mode
                   (legacy), a disabled DropConfig materializes the trace
                   (VDC), an enabled one with p ≥ 1 drops it completely and
                   recomputes messages on demand (JOD, per §4 — partial join
                   dropping is not supported).
    ``Iterate``    the semiring fixed point (today's IFE); owns the
                   change-point difference store and the §5 partial-dropping
                   policy.
    ``Aggregate``  post-processing over the fixed point's answers (top-k /
                   distance histogram); stateless, holds no differences.

Node identity (``op_id``) is threaded through the whole stack: engines
report ``nbytes_per_operator`` keyed ``(slot, op_id)``, drop policies are
rewritten per ``(slot, op_id)``, and the memory governor escalates the
*operator* with the worst bytes-per-recompute-cost.

``family_key`` is stable under node *listing order* — two graphs with the
same nodes in a different tuple order are the same family — and excludes
per-query knobs (source vertex, drop selection, aggregate shaping).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import dropping as dr
from repro_torch.core import semiring as sr

INF = np.float32(np.inf)

OP_KINDS = ("ingest", "transform", "join", "iterate", "aggregate")
# operators that may own a difference store (and hence a drop policy)
DROPPABLE_OPS = ("iterate", "join")


# --------------------------------------------------------------------------- NFA
@dataclasses.dataclass(frozen=True)
class NFA:
    """Nondeterministic automaton over edge labels.

    ``delta``: label → [(state, state')] transitions; used to build the
    product graph (v, q) whose reachability answers the RPQ.
    """

    num_states: int
    delta: dict[int, list[tuple[int, int]]]
    start: int
    accept: tuple[int, ...]

    @staticmethod
    def star(label: int) -> "NFA":
        """Q1 = a*"""
        return NFA(1, {label: [(0, 0)]}, 0, (0,))

    @staticmethod
    def concat_star(a: int, b: int) -> "NFA":
        """Q2 = a ∘ b*"""
        return NFA(2, {a: [(0, 1)], b: [(1, 1)]}, 0, (1,))

    @staticmethod
    def chain(labels: Sequence[int]) -> "NFA":
        """Q3 = l1 ∘ l2 ∘ … ∘ lk (fixed-length path template)."""
        delta: dict[int, list[tuple[int, int]]] = {}
        for j, lbl in enumerate(labels):
            delta.setdefault(int(lbl), []).append((j, j + 1))
        return NFA(len(labels) + 1, delta, 0, (len(labels),))

    def key(self) -> tuple:
        """Hashable structural identity, independent of ``delta`` insertion
        order AND of the listing order of one label's transition pairs."""
        delta = tuple(
            (lbl, tuple(sorted(pairs))) for lbl, pairs in sorted(self.delta.items())
        )
        return (self.num_states, delta, self.start, tuple(sorted(self.accept)))

    def __hash__(self) -> int:  # delta is a dict → default frozen hash fails
        return hash(self.key())

    def __eq__(self, other) -> bool:
        return isinstance(other, NFA) and self.key() == other.key()

    def to_dict(self) -> dict:
        return {
            "num_states": self.num_states,
            "delta": [
                [int(lbl), [[int(s), int(s2)] for (s, s2) in pairs]]
                for lbl, pairs in sorted(self.delta.items())
            ],
            "start": self.start,
            "accept": list(self.accept),
        }

    @staticmethod
    def from_dict(obj: dict) -> "NFA":
        return NFA(
            num_states=int(obj["num_states"]),
            delta={
                int(lbl): [(int(s), int(s2)) for (s, s2) in pairs]
                for lbl, pairs in obj["delta"]
            },
            start=int(obj["start"]),
            accept=tuple(int(a) for a in obj["accept"]),
        )


# --------------------------------------------------------------------------- init spec
@dataclasses.dataclass(frozen=True)
class InitSpec:
    """How to build a query's D_0 row (the implicit iteration-0 diffs).

    ``kind``:
      * ``"source"``   — ``value`` at ``source``, ``fill`` elsewhere
        (SSSP/K-hop/RPQ; for RPQ ``source`` is the product-space id).
      * ``"labels"``   — vertex id as the initial label (WCC).
      * ``"constant"`` — ``fill`` everywhere (PageRank's all-ones).
    """

    kind: str = "source"
    source: int | None = None
    value: float = 0.0
    fill: float = float(INF)

    def build(self, num_vertices: int) -> np.ndarray:
        if self.kind == "source":
            row = np.full(num_vertices, self.fill, dtype=np.float32)
            row[int(self.source)] = self.value
            return row
        if self.kind == "labels":
            return np.arange(num_vertices, dtype=np.float32)
        if self.kind == "constant":
            return np.full(num_vertices, self.fill, dtype=np.float32)
        raise ValueError(f"unknown init kind {self.kind!r}")

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "source": self.source,
            "value": self.value,
            "fill": self.fill,
        }

    @staticmethod
    def from_dict(obj: dict) -> "InitSpec":
        return InitSpec(
            kind=obj.get("kind", "source"),
            source=None if obj.get("source") is None else int(obj["source"]),
            value=float(obj.get("value", 0.0)),
            fill=float(obj.get("fill", INF)),
        )


# --------------------------------------------------------------------------- nodes
@dataclasses.dataclass(frozen=True, kw_only=True)
class Ingest:
    """Edge deltas entering the dataflow (one per plan, no inputs)."""

    kind = "ingest"
    op_id: str = "ingest"
    inputs: tuple[str, ...] = ()

    def family_key(self) -> tuple:
        return ("ingest", self.op_id, self.inputs)


@dataclasses.dataclass(frozen=True, kw_only=True)
class Transform:
    """Per-edge weight derivation (PageRank: w = α / outdeg(src))."""

    kind = "transform"
    op_id: str = "weights"
    inputs: tuple[str, ...] = ("ingest",)
    weight_from_degree: bool = True
    alpha: float = 0.85

    def family_key(self) -> tuple:
        return (
            "transform",
            self.op_id,
            self.inputs,
            bool(self.weight_from_degree),
            float(self.alpha),
        )


@dataclasses.dataclass(frozen=True, kw_only=True)
class Join:
    """NFA-product construction + the join trace inside the fixed point.

    ``drop`` is the operator's OWN storage policy:
      * ``None``     — inherit the engine mode (legacy ``mode="vdc"|"jod"``);
      * disabled     — materialize the per-edge message trace (VDC);
      * enabled      — complete dropping, p ≥ 1 (JOD §4): the trace is never
                       stored; messages recompute on demand every sweep.
    """

    kind = "join"
    op_id: str = "join"
    inputs: tuple[str, ...] = ("ingest",)
    nfa: NFA | None = None
    drop: dr.DropConfig | None = None

    def family_key(self) -> tuple:
        # drop is a per-query knob (free within a family)
        return (
            "join",
            self.op_id,
            self.inputs,
            None if self.nfa is None else self.nfa.key(),
        )


@dataclasses.dataclass(frozen=True, kw_only=True)
class Iterate:
    """The semiring fixed point (IFE) — owns the change-point store."""

    kind = "iterate"
    op_id: str = "iterate"
    inputs: tuple[str, ...] = ("ingest",)
    semiring: sr.Semiring | None = None
    init: InitSpec = dataclasses.field(default_factory=InitSpec)
    max_iters: int = 64
    drop: dr.DropConfig = dataclasses.field(default_factory=dr.DropConfig)

    def family_key(self) -> tuple:
        s = self.semiring
        return (
            "iterate",
            self.op_id,
            self.inputs,
            s.name,
            s.reduce,
            s.identity,
            s.carry_prev,
            s.base,
            s.hop_cap,
            int(self.max_iters),
        )


@dataclasses.dataclass(frozen=True, kw_only=True)
class Aggregate:
    """Stateless post-processing of the fixed point's answers.

    ``agg``: ``"topk"`` (k best finite values + their vertices),
    ``"histogram"`` (finite-value counts in ``bins`` equal-width bins) or
    ``"target"`` (the answer field read at one ``vertex`` — SPSP reads an
    SSSP field at t; the planner's landmark pass pattern-matches on it).
    A per-query output-shaping knob: excluded from the family key.
    """

    kind = "aggregate"
    op_id: str = "aggregate"
    inputs: tuple[str, ...] = ("iterate",)
    agg: str = "topk"
    k: int = 8
    bins: int = 8
    vertex: int | None = None  # target vertex for agg="target"

    def family_key(self) -> tuple | None:
        return None  # free knob — never constrains session compatibility


OpNode = Ingest | Transform | Join | Iterate | Aggregate


# ----------------------------------------------------------------- validation
def _toposort(nodes: dict[str, OpNode]) -> list[str]:
    """Kahn topological order; raises on cycles."""
    indeg = {op_id: 0 for op_id in nodes}
    consumers: dict[str, list[str]] = {op_id: [] for op_id in nodes}
    for node in nodes.values():
        for ref in node.inputs:
            indeg[node.op_id] += 1
            consumers[ref].append(node.op_id)
    ready = sorted(op_id for op_id, d in indeg.items() if d == 0)
    order: list[str] = []
    while ready:
        op_id = ready.pop()
        order.append(op_id)
        for c in consumers[op_id]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(nodes):
        cyclic = sorted(op_id for op_id, d in indeg.items() if d > 0)
        raise ValueError(f"operator graph has a cycle through {cyclic}")
    return order


def validate(ops: Sequence[OpNode]) -> dict[str, OpNode]:
    """Validate an operator graph; returns the id → node map.

    Checks: unique ids, no dangling input references, acyclicity, exactly
    one Ingest (no inputs) and one Iterate, at most one Join / Transform /
    Aggregate, the Iterate reachable from the Ingest, the Aggregate fed by
    the Iterate, and join drop configs restricted to complete dropping.
    """
    if not ops:
        raise ValueError("operator graph is empty")
    nodes: dict[str, OpNode] = {}
    for node in ops:
        if not isinstance(node, (Ingest, Transform, Join, Iterate, Aggregate)):
            raise ValueError(f"unknown operator node {node!r}")
        if node.op_id in nodes:
            raise ValueError(f"duplicate operator id {node.op_id!r}")
        nodes[node.op_id] = node
    for node in ops:
        for ref in node.inputs:
            if ref not in nodes:
                raise ValueError(
                    f"operator {node.op_id!r} references dangling input {ref!r}"
                )
            if ref == node.op_id:
                raise ValueError(f"operator {node.op_id!r} consumes itself")
    _toposort(nodes)

    by_kind: dict[str, list[OpNode]] = {}
    for node in ops:
        by_kind.setdefault(node.kind, []).append(node)
    for kind in ("ingest", "iterate"):
        if len(by_kind.get(kind, [])) != 1:
            raise ValueError(
                f"operator graph needs exactly one {kind} node, "
                f"got {len(by_kind.get(kind, []))}"
            )
    for kind in ("join", "transform", "aggregate"):
        if len(by_kind.get(kind, [])) > 1:
            raise ValueError(f"operator graph allows at most one {kind} node")
    if by_kind["ingest"][0].inputs:
        raise ValueError("the ingest node consumes nothing (it IS the δE source)")

    it = by_kind["iterate"][0]
    if it.semiring is None:
        raise ValueError("the iterate node needs a semiring")
    # store-owning operators are engine-addressed by kind (a plan holds at
    # most one of each), so their ids must BE their kind — a free-form id
    # would make the node unaddressable and surface phantom 0-byte twins
    for kind in DROPPABLE_OPS:
        for node in by_kind.get(kind, []):
            if node.op_id != kind:
                raise ValueError(
                    f"{kind} nodes own a difference store and must keep the "
                    f"canonical id {kind!r} (got {node.op_id!r})"
                )
    # the iterate must (transitively) consume the ingest
    seen, stack = set(), [it.op_id]
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(nodes[cur].inputs)
    if by_kind["ingest"][0].op_id not in seen:
        raise ValueError("the iterate node is not connected to the ingest")

    for agg in by_kind.get("aggregate", []):
        if it.op_id not in agg.inputs:
            raise ValueError(
                f"aggregate {agg.op_id!r} must consume the iterate node "
                f"{it.op_id!r}"
            )
        if agg.agg == "target" and agg.vertex is None:
            raise ValueError("aggregate agg='target' needs a target vertex")
    for join in by_kind.get("join", []):
        if join.nfa is None:
            raise ValueError(f"join {join.op_id!r} needs an NFA")
        cfg = join.drop
        if cfg is not None and cfg.enabled() and not cfg.drops_all():
            raise ValueError(
                "the join's differences drop completely (p ≥ 1, recompute"
                "-on-demand per §4); partial join dropping is unsupported"
            )
    return nodes


def family_key(ops: Sequence[OpNode]) -> tuple:
    """Session-compatibility key over the graph, stable under node listing
    order; per-query knobs (init source, drop policies, aggregates) free."""
    keys = [n.family_key() for n in ops]
    return tuple(sorted((k for k in keys if k is not None), key=repr))


# ------------------------------------------------------------ canonical graphs
def canonical(
    *,
    semiring: sr.Semiring,
    init: InitSpec,
    max_iters: int,
    drop: dr.DropConfig | None = None,
    nfa: NFA | None = None,
    weight_from_degree: bool = False,
    alpha: float = 0.85,
    join_drop: dr.DropConfig | None = None,
    aggregate: Aggregate | None = None,
) -> tuple[OpNode, ...]:
    """The canonical operator graph for one legacy-shaped query."""
    ops: list[OpNode] = [Ingest()]
    upstream = "ingest"
    if weight_from_degree:
        ops.append(
            Transform(
                inputs=(upstream,), weight_from_degree=True, alpha=float(alpha)
            )
        )
        upstream = "weights"
    if nfa is not None:
        ops.append(Join(inputs=(upstream,), nfa=nfa, drop=join_drop))
        upstream = "join"
    ops.append(
        Iterate(
            inputs=(upstream,),
            semiring=semiring,
            init=init,
            max_iters=int(max_iters),
            drop=drop if drop is not None else dr.DropConfig(),
        )
    )
    if aggregate is not None:
        ops.append(dataclasses.replace(aggregate, inputs=("iterate",)))
    return tuple(ops)


# ----------------------------------------------------------------------- JSON
def _semiring_to_dict(s: sr.Semiring) -> dict:
    out: dict = {"name": s.name}
    if s.name == "min_hop":
        out["hop_cap"] = s.hop_cap
    if s.name == "pagerank":
        out["alpha"] = 1.0 - s.base
    return out


def _semiring_from_dict(obj: dict) -> sr.Semiring:
    name = obj["name"]
    if name == "min_plus":
        return sr.min_plus()
    if name == "min_hop":
        return sr.min_hop(float(obj.get("hop_cap", float("inf"))))
    if name == "min_label":
        return sr.min_label()
    if name == "pagerank":
        return sr.pagerank(float(obj.get("alpha", 0.85)))
    raise ValueError(f"unknown semiring {name!r}")


def _drop_to_dict(cfg: dr.DropConfig | None) -> dict | None:
    return None if cfg is None else dataclasses.asdict(cfg)


def _drop_from_dict(obj: dict | None) -> dr.DropConfig | None:
    if obj is None:
        return None
    fields = {f.name for f in dataclasses.fields(dr.DropConfig)}
    return dr.DropConfig(**{k: v for k, v in obj.items() if k in fields})


def node_to_dict(node: OpNode) -> dict:
    out: dict = {"op": node.kind, "id": node.op_id, "inputs": list(node.inputs)}
    if isinstance(node, Transform):
        out["weight_from_degree"] = node.weight_from_degree
        out["alpha"] = node.alpha
    elif isinstance(node, Join):
        out["nfa"] = node.nfa.to_dict()
        out["drop"] = _drop_to_dict(node.drop)
    elif isinstance(node, Iterate):
        out["semiring"] = _semiring_to_dict(node.semiring)
        out["init"] = node.init.to_dict()
        out["max_iters"] = node.max_iters
        out["drop"] = _drop_to_dict(node.drop)
    elif isinstance(node, Aggregate):
        out["agg"] = node.agg
        out["k"] = node.k
        out["bins"] = node.bins
        out["vertex"] = node.vertex
    return out


def node_from_dict(obj: dict) -> OpNode:
    kind = obj.get("op")
    common = dict(
        op_id=obj.get("id", kind), inputs=tuple(obj.get("inputs", ()))
    )
    if kind == "ingest":
        return Ingest(**common)
    if kind == "transform":
        return Transform(
            **common,
            weight_from_degree=bool(obj.get("weight_from_degree", True)),
            alpha=float(obj.get("alpha", 0.85)),
        )
    if kind == "join":
        return Join(
            **common,
            nfa=NFA.from_dict(obj["nfa"]),
            drop=_drop_from_dict(obj.get("drop")),
        )
    if kind == "iterate":
        drop = _drop_from_dict(obj.get("drop"))
        return Iterate(
            **common,
            semiring=_semiring_from_dict(obj["semiring"]),
            init=InitSpec.from_dict(obj.get("init", {})),
            max_iters=int(obj.get("max_iters", 64)),
            drop=drop if drop is not None else dr.DropConfig(),
        )
    if kind == "aggregate":
        vertex = obj.get("vertex")
        return Aggregate(
            **common,
            agg=obj.get("agg", "topk"),
            k=int(obj.get("k", 8)),
            bins=int(obj.get("bins", 8)),
            vertex=None if vertex is None else int(vertex),
        )
    raise ValueError(f"unknown operator kind {kind!r}")
