"""Neighbour sampler for minibatch GNN training (GraphSAGE-style fanout).

The port of ``repro/data/sampler.py`` (numpy only): seed nodes →
fanout-bounded neighbour expansion per hop → fixed-shape padded subgraph.
The sampler runs on the host over CSR adjacency and draws from the caller's
``rng`` exactly as the reference does, so one ``rng`` state samples the
same subgraph in both packages.  :meth:`CSRGraph.from_edges` counts
out-degrees with ``np.bincount`` where the reference uses ``np.add.at``
(the same ``indptr``; at 10^8 edges ``np.add.at`` takes seconds).  The
incremental variant keeps per-seed K-hop frontiers fresh under edge updates
with the Diff-IFE K-hop engine as its index (``core/queries.khop``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [V+1]
    indices: np.ndarray  # [E]
    num_nodes: int

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, num_nodes: int) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        indptr = np.zeros(num_nodes + 1, np.int64)
        indptr[1:] = np.bincount(src_s, minlength=num_nodes)[:num_nodes]
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=dst_s.astype(np.int32), num_nodes=num_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]


@dataclasses.dataclass
class SampledSubgraph:
    """Fixed-shape padded subgraph in *local* node ids; nodes 0.. are the seeds."""

    node_ids: np.ndarray  # int32 [N_max] global ids (padded with -1)
    edge_src: np.ndarray  # int32 [E_max] local ids (padding 0, masked)
    edge_dst: np.ndarray  # int32 [E_max]
    node_mask: np.ndarray  # bool [N_max]
    edge_mask: np.ndarray  # bool [E_max]
    num_seeds: int


def sample_subgraph(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    *,
    max_nodes: int,
    max_edges: int,
    rng: np.random.Generator,
) -> SampledSubgraph:
    """Layer-wise fanout sampling; returns a padded block subgraph."""
    local: dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
    nodes = [int(s) for s in seeds]
    e_src: list[int] = []
    e_dst: list[int] = []
    frontier = list(seeds)
    for fan in fanouts:
        nxt: list[int] = []
        for v in frontier:
            nbrs = g.neighbors(int(v))
            if len(nbrs) > fan:
                nbrs = rng.choice(nbrs, size=fan, replace=False)
            for u in nbrs:
                u = int(u)
                if u not in local:
                    if len(nodes) >= max_nodes:
                        continue
                    local[u] = len(nodes)
                    nodes.append(u)
                if len(e_src) < max_edges:
                    # message flows u → v (neighbour into the seed side)
                    e_src.append(local[u])
                    e_dst.append(local[int(v)])
                    nxt.append(u)
        frontier = nxt
        if not frontier:
            break
    n, e = len(nodes), len(e_src)
    node_ids = np.full(max_nodes, -1, np.int32)
    node_ids[:n] = nodes
    src = np.zeros(max_edges, np.int32)
    dst = np.zeros(max_edges, np.int32)
    src[:e], dst[:e] = e_src, e_dst
    return SampledSubgraph(
        node_ids=node_ids,
        edge_src=src,
        edge_dst=dst,
        node_mask=np.arange(max_nodes) < n,
        edge_mask=np.arange(max_edges) < e,
        num_seeds=len(seeds),
    )
