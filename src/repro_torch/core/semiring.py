"""Semirings parameterizing the Iterative Frontier Expansion (IFE) dataflow.

The paper's IFE template (Fig. 1a) is a ``Join`` (per-edge message) feeding an
aggregator (``Min`` for Bellman-Ford, Fig. 1b).  That pair is factored as a
semiring-like structure so one engine serves every query class in the paper
(SPSP/SSSP, K-hop, RPQ, WCC, PageRank):

    new_state[u] = reduce_{(v,u) in E} msg(state[v], w(v,u))   (+ carry of
                   state[u] when ``carry_prev``)

``identity`` is the reduce identity (also the "no value yet" state for
vertices other than the query source).  ``msg`` works on float32 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    # reduce: 'min' | 'sum'  (scatter reduction used by the SpMV)
    reduce: str
    # msg(src_state, edge_weight) -> message value
    msg: Callable[[Tensor, Tensor], Tensor]
    # identity element of the reduction (also the implicit initial state of
    # non-source vertices; see DiffStore: init diffs are implicit).
    identity: float
    # Whether D_i includes the vertex's own previous value:
    #   D_i(u) = reduce(msg over in-edges, D_{i-1}(u))       (min queries)
    #   D_i(u) = base + reduce(msg over in-edges)            (PageRank)
    carry_prev: bool = True
    # Additive per-vertex base applied after the reduction (PageRank teleport).
    base: float = 0.0
    # Hop truncation for min_hop: messages past this hop count collapse to the
    # identity (K-hop queries).  inf = no truncation.
    hop_cap: float = INF

    @property
    def kernel_name(self) -> str:
        """Name of this semiring in the ELL-SpMV kernel."""
        return {"pagerank": "pr_sum"}.get(self.name, self.name)


def min_plus() -> Semiring:
    """Shortest paths: msg = d_v + w, reduce = min."""
    return Semiring(
        name="min_plus",
        reduce="min",
        msg=lambda s, w: s + w,
        identity=INF,
        carry_prev=True,
    )


def min_hop(max_hops: float = INF) -> Semiring:
    """K-hop / BFS: msg = hops_v + 1, reduce = min.

    ``max_hops`` truncates propagation (a reached vertex at exactly K hops
    does not propagate further); the engine also bounds iterations by K.
    """

    def msg(s, w):  # noqa: ANN001
        del w
        cand = s + 1.0
        return torch.where(cand > max_hops, INF, cand)

    return Semiring(
        name="min_hop",
        reduce="min",
        msg=msg,
        identity=INF,
        carry_prev=True,
        hop_cap=float(max_hops),
    )


def min_label() -> Semiring:
    """WCC label propagation: msg = label_v, reduce = min."""
    return Semiring(
        name="min_label",
        reduce="min",
        msg=lambda s, w: s,
        identity=INF,
        carry_prev=True,
    )


def pagerank(alpha: float = 0.85) -> Semiring:
    """Pregel-style PageRank: msg = alpha * pr_v / outdeg_v, reduce = sum.

    The engine passes ``w = alpha / outdeg(src)`` as the edge weight so the
    message is a plain product; teleport enters via ``base``.
    """
    return Semiring(
        name="pagerank",
        reduce="sum",
        msg=lambda s, w: s * w,
        identity=0.0,
        carry_prev=False,
        base=1.0 - alpha,
    )


def reduce_pair(sr: Semiring, a: Tensor, b: Tensor) -> Tensor:
    if sr.reduce == "min":
        return torch.minimum(a, b)
    if sr.reduce == "sum":
        return a + b
    raise ValueError(f"unknown reduce {sr.reduce!r}")
