"""Landmark-index application of Diff-IFE (paper §6.6, Fig. 9).

The port of ``repro/core/landmark.py``.  A landmark index stores shortest
distances between every vertex and a small set of high-degree "landmark"
vertices.  Per landmark l two SSSP fields are maintained differentially:

    fwd[l, v] = d(l → v)     — SSSP on G from l
    rev[l, v] = d(v → l)     — SSSP on Gᵀ from l

From these, triangle bounds prune the Bellman-Ford search of SCRATCH:

    ub(s, t)  = min_l rev[l, s] + fwd[l, t]                 (d(s,t) ≤ ub)
    lb(v, t)  = max_l max(fwd[l, t] − fwd[l, v],
                          rev[l, v] − rev[l, t])            (d(v,t) ≥ lb)

During the SPSP scratch run from s to t, a vertex v with
``dist(v) + lb(v, t) > ub`` cannot lie on a shortest s→t path, so it never
propagates — the paper's SCRATCH-LANDMARK.

The bounds and the pruned Bellman-Ford are plain PyTorch on the session's
device (the reference's are XLA code, no Pallas kernel).  The production
form is the plan-optimizer rewrite (`repro_torch.planner.landmark_rewrite`);
:class:`LandmarkIndex` and :class:`ScratchLandmark` are the direct-engine
wrappers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import dropping as dr
from repro_torch.core import semiring as sr
from repro_torch.core.engine import DiffIFE, EngineConfig, GraphArrays, edge_messages, resolve_device
from repro_torch.core.graph import DynamicGraph

Tensor = torch.Tensor
INF = np.float32(np.inf)


# ----------------------------------------------------------------- helpers
def source_init(sources: Sequence[int], num_vertices: int, value: float = 0.0) -> np.ndarray:
    """Stacked source-init rows [Q, V] (the plan-IR form is
    ``InitSpec(kind="source")``; this is the raw-engine equivalent)."""
    init = np.full((len(sources), num_vertices), INF, dtype=np.float32)
    for q, s in enumerate(sources):
        init[q, int(s)] = value
    return init


def engine_cfg(
    num_queries: int,
    num_vertices: int,
    semiring,
    *,
    max_iters: int,
    mode: str = "jod",
    drop: dr.DropConfig | None = None,
    weight_from_degree: bool = False,
    **kw,
) -> EngineConfig:
    """Raw :class:`EngineConfig` builder for the direct-engine wrappers and
    the planner's pruned-scratch runs."""
    return EngineConfig(
        num_queries=num_queries,
        num_vertices=num_vertices,
        max_iters=max_iters,
        semiring=semiring,
        mode=mode,
        drop=drop or dr.DropConfig(),
        weight_from_degree=weight_from_degree,
        **kw,
    )


def transpose_updates(updates) -> list[tuple[int, int, int, float, int]]:
    """δE on G → δE on Gᵀ (swap endpoints, keep label/weight/sign)."""
    return [(v, u, lbl, w, sign) for (u, v, lbl, w, sign) in updates]


def transpose_graph(graph: DynamicGraph) -> DynamicGraph:
    """Gᵀ as a fresh :class:`DynamicGraph` (same capacity and vertex space).

    The live-edge arrays are gathered and written through fancy indexing;
    live edges compact to the low slots, so the twin's free list is the
    plain tail range.
    """
    v, cap = graph.num_vertices, graph.capacity
    live = np.nonzero(graph.valid)[0]
    n = int(live.size)
    src = graph.dst[live].astype(np.int32)  # transposed endpoints
    dst = graph.src[live].astype(np.int32)
    arrays = {name: np.zeros(cap, dtype=dtype) for name, dtype in DynamicGraph._ARRAYS[:5]}
    arrays["src"][:n], arrays["dst"][:n] = src, dst
    arrays["weight"][:n], arrays["label"][:n] = graph.weight[live], graph.label[live]
    arrays["valid"][:n] = True
    arrays["out_degree"] = np.bincount(src, minlength=v)
    arrays["in_degree"] = np.bincount(dst, minlength=v)
    return DynamicGraph.assemble(v, arrays, list(range(cap - 1, n - 1, -1)), weighted=graph.weighted)


def select_landmarks(graph: DynamicGraph, num_landmarks: int) -> list[int]:
    """The ``num_landmarks`` highest-total-degree vertices (§6.6)."""
    deg = graph.degrees_total()
    return [int(l) for l in np.argsort(-deg, kind="stable")[: int(num_landmarks)]]


def _f32(x, device) -> Tensor:
    """A float32 tensor of ``x`` on ``device`` (its own when ``None``); an
    array is copied, so a read-only one is fine."""
    if not isinstance(x, Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(dtype=torch.float32, device=device)


def triangle_bounds(fwd, rev, sources: Sequence[int], targets: Sequence[int]) -> tuple[Tensor, Tensor]:
    """Per-query pruning bounds ``(lb [Q, V], ub [Q])`` on ``fwd``'s device.

    ``fwd``/``rev`` are ``[L, V]`` (tensors or arrays).  inf − inf → nan: no
    information → 0.  A +inf lower bound is *valid* (l reaches v but not t
    ⇒ v cannot reach t) and prunes v outright.  The reference's ``[L, Q,
    V]`` differences are taken one landmark at a time: the same f32
    operations, and max is exact in any order.
    """
    fwd = _f32(fwd, None)
    rev = _f32(rev, fwd.device)
    s = torch.as_tensor(np.asarray(sources, np.int64), device=fwd.device)
    t = torch.as_tensor(np.asarray(targets, np.int64), device=fwd.device)
    ub = (rev[:, s] + fwd[:, t]).amin(dim=0)  # [Q]
    lb = None
    for l in range(fwd.shape[0]):
        d = torch.maximum(
            fwd[l, t][:, None] - fwd[l][None, :],  # [Q, V]
            rev[l][None, :] - rev[l, t][:, None],
        )
        d = torch.where(torch.isnan(d), 0.0, d).clamp_(min=0.0)
        lb = d if lb is None else torch.maximum(lb, d)
    return lb, ub


# -------------------------------------------------------------- legacy index
class LandmarkIndex:
    """Differentially-maintained landmark distance index (direct engines)."""

    def __init__(
        self,
        graph: DynamicGraph,
        landmarks: Sequence[int],
        *,
        max_iters: int = 64,
        device=None,
        **kw,
    ) -> None:
        self.landmarks = [int(l) for l in landmarks]
        v = graph.num_vertices
        self.graph = graph
        # the forward engine shares the caller's graph object; the reverse
        # engine owns a transposed twin fed with transposed update batches
        self.rgraph = transpose_graph(graph)
        cfg = engine_cfg(len(self.landmarks), v, sr.min_plus(), max_iters=max_iters, **kw)
        init = source_init(self.landmarks, v)
        self.fwd_engine = DiffIFE(cfg, graph, init, device=device)
        self.rev_engine = DiffIFE(cfg, self.rgraph, init, device=device)

    def apply_updates(self, updates) -> None:
        self.fwd_engine.apply_updates(updates)
        self.rev_engine.apply_updates(transpose_updates(updates))

    @property
    def fwd(self) -> np.ndarray:  # [L, V] d(l → v)
        return self.fwd_engine.answers()

    @property
    def rev(self) -> np.ndarray:  # [L, V] d(v → l)
        return self.rev_engine.answers()

    def nbytes(self) -> int:
        return self.fwd_engine.nbytes() + self.rev_engine.nbytes()


def _pruned_bf(cfg: EngineConfig, g: GraphArrays, init: Tensor, lb: Tensor, ub: Tensor) -> tuple[Tensor, int, int]:
    """Bellman-Ford with landmark pruning: pruned vertices never propagate.

    Returns ``(final [Q, V], iters, work)`` where ``work`` counts the live
    (propagating) vertex slots summed over iterations — the deterministic
    scratch-work meter Fig. 9 reports (the un-pruned baseline's analog is
    ``iters · Q · V``), in int64.  One host sync an iteration reads the
    loop's ``changed`` flag, as the reference's ``while_loop`` condition.
    """
    q, v = init.shape
    idx = g.dst.long()[None, :].expand(q, -1)
    ub = ub[:, None]
    cur = init
    work = torch.zeros((), dtype=torch.int64, device=init.device)
    i, changed = 1, True
    while i <= cfg.max_iters and changed:
        live = (cur + lb) <= ub  # can still be on a shortest path
        masked = torch.where(live, cur, torch.inf)
        seg = torch.full((q, v), torch.inf, dtype=cur.dtype, device=cur.device)
        seg.scatter_reduce_(1, idx, edge_messages(cfg, masked, g), "amin", include_self=True)
        new = torch.minimum(cur, seg)
        work += live.sum(dtype=torch.int64)
        changed = bool((new != cur).any())
        cur, i = new, i + 1
    return cur, i - 1, int(work)


def pruned_scratch_run(
    cfg: EngineConfig,
    graph: DynamicGraph,
    sources: Sequence[int],
    targets: Sequence[int],
    fwd,
    rev,
    *,
    g: GraphArrays | None = None,
    device=None,
) -> tuple[Tensor, int, int]:
    """One SCRATCH-LANDMARK evaluation: ``(dists [Q, V], iters, work)``.

    ``fwd``/``rev`` are the index fields ([L, V]); pass ``None`` for both to
    run with trivial bounds (lb = 0, ub = ∞ — plain scratch, used while the
    governor holds the index shed).  Distances are exact at each query's
    target; pruned vertices elsewhere may read +inf.  ``g`` is a device
    view of ``graph`` when the caller keeps one current (a dense engine's);
    else it is built from the graph's snapshot on ``device``.  ``dists``
    stays on the device.
    """
    device = g.src.device if g is not None else resolve_device(device)
    v = graph.num_vertices
    if fwd is None or rev is None:
        lb = torch.zeros((len(sources), v), dtype=torch.float32, device=device)
        ub = torch.full((len(sources),), torch.inf, dtype=torch.float32, device=device)
    else:
        lb, ub = triangle_bounds(_f32(fwd, device), rev, sources, targets)
    if g is None:
        g = GraphArrays.from_snapshot(graph.snapshot(), device=device)
    init = torch.from_numpy(source_init(sources, v)).to(device)
    return _pruned_bf(cfg, g, init, lb, ub)


class ScratchLandmark:
    """SCRATCH-LANDMARK (§6.6): scratch SPSP with landmark pruning.

    Updates first maintain the landmark index differentially, then each
    registered (s, t) query re-runs pruned Bellman-Ford from scratch.
    Direct-engine wrapper — the session form is
    ``CQPSession.register(plan.spsp(s, t), optimize="always")``.
    """

    def __init__(
        self,
        graph: DynamicGraph,
        queries: Sequence[tuple[int, int]],
        num_landmarks: int = 10,
        *,
        max_iters: int = 64,
        device=None,
        **kw,
    ) -> None:
        self.graph = graph
        self.device = resolve_device(device)
        self.queries = [(int(s), int(t)) for s, t in queries]
        landmarks = select_landmarks(graph, num_landmarks)
        self.index = LandmarkIndex(graph, landmarks, max_iters=max_iters, device=self.device, **kw)
        self.cfg = engine_cfg(len(queries), graph.num_vertices, sr.min_plus(), max_iters=max_iters)
        self._recompute()

    def _recompute(self) -> None:
        self._dists, self.last_iters, self.last_work = pruned_scratch_run(
            self.cfg,
            self.graph,
            [q[0] for q in self.queries],
            [q[1] for q in self.queries],
            self.index.fwd_engine.state.cur,
            self.index.rev_engine.state.cur,
            g=self.index.fwd_engine.g,
        )

    def apply_updates(self, updates) -> None:
        self.index.apply_updates(updates)  # graph mutated here (fwd engine)
        self._recompute()

    def answers(self) -> np.ndarray:
        """Shortest s→t distance per registered query."""
        t = torch.as_tensor([q[1] for q in self.queries], device=self.device)
        return self._dists[torch.arange(len(self.queries), device=self.device), t].cpu().numpy()

    def nbytes(self) -> int:
        return self.index.nbytes()
