"""Synthetic dynamic-graph workloads mirroring the paper's setup (§6.1).

The paper shuffles each dataset, loads 90% as the initial graph and streams
the remaining 10% as updates.  We generate power-law graphs (LiveJournal/
Orkut-like), uniform graphs (Patents-like) and labelled graphs (LDBC-like),
then split them the same way.  All generators are seeded and deterministic.
"""

from __future__ import annotations

import numpy as np

Edge = tuple  # (u, v, w[, label])


def powerlaw_graph(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    weighted: bool = True,
    exponent: float = 1.2,
    num_labels: int = 0,
) -> list[Edge]:
    """Directed multigraph-free power-law graph (preferential endpoints)."""
    rng = np.random.default_rng(seed)
    # Zipfian vertex popularity for destination choice → heavy-tailed in-degree
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    probs = ranks ** (-exponent)
    probs /= probs.sum()
    perm = rng.permutation(num_vertices)
    seen: set[tuple[int, int]] = set()
    edges: list[Edge] = []
    while len(edges) < num_edges:
        u = int(perm[rng.choice(num_vertices, p=probs)])
        v = int(perm[rng.choice(num_vertices, p=probs)])
        if u == v or (u, v) in seen:
            continue
        seen.add((u, v))
        w = float(rng.integers(1, 11)) if weighted else 1.0
        if num_labels:
            edges.append((u, v, w, int(rng.integers(1, num_labels + 1))))
        else:
            edges.append((u, v, w))
    return edges


def uniform_graph(
    num_vertices: int, num_edges: int, *, seed: int = 0, weighted: bool = True
) -> list[Edge]:
    rng = np.random.default_rng(seed)
    seen: set[tuple[int, int]] = set()
    edges: list[Edge] = []
    while len(edges) < num_edges:
        u, v = (int(x) for x in rng.integers(0, num_vertices, 2))
        if u == v or (u, v) in seen:
            continue
        seen.add((u, v))
        edges.append((u, v, float(rng.integers(1, 11)) if weighted else 1.0))
    return edges


def split_90_10(edges: list[Edge], *, seed: int = 0) -> tuple[list[Edge], list[Edge]]:
    """Paper §6.1: shuffle, 90% initial graph, 10% update stream."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(edges))
    cut = int(len(edges) * 0.9)
    return [edges[i] for i in order[:cut]], [edges[i] for i in order[cut:]]


def update_stream(
    existing: list[Edge],
    num_vertices: int,
    *,
    num_batches: int,
    batch_size: int = 1,
    delete_fraction: float = 0.0,
    insert_pool: list[Edge] | None = None,
    seed: int = 0,
) -> list[list[tuple[int, int, int, float, int]]]:
    """Batched update stream: inserts from a pool (or fresh random edges) and
    deletes of currently-present edges, in the paper's (u,v,l,w,±) form."""
    rng = np.random.default_rng(seed)
    present = {(int(e[0]), int(e[1])): e for e in existing}
    pool = list(insert_pool or [])
    batches = []
    for _ in range(num_batches):
        batch = []
        for _ in range(batch_size):
            if present and rng.random() < delete_fraction:
                key = list(present)[int(rng.integers(len(present)))]
                e = present.pop(key)
                lbl = int(e[3]) if len(e) > 3 else 0
                batch.append((key[0], key[1], lbl, float(e[2]), -1))
            else:
                if pool:
                    e = pool.pop()
                    key = (int(e[0]), int(e[1]))
                    if key in present:
                        continue
                    lbl = int(e[3]) if len(e) > 3 else 0
                    present[key] = e
                    batch.append((key[0], key[1], lbl, float(e[2]), +1))
                else:
                    u, v = (int(x) for x in rng.integers(0, num_vertices, 2))
                    if u == v or (u, v) in present:
                        continue
                    w = float(rng.integers(1, 11))
                    present[(u, v)] = (u, v, w)
                    batch.append((u, v, 0, w, +1))
        if batch:
            batches.append(batch)
    return batches


def ldbc_like_graph(
    num_vertices: int, num_edges: int, *, seed: int = 0, num_labels: int = 4
) -> list[Edge]:
    """Labelled social-network-like graph (stand-in for LDBC SNB): label 1 ~
    Knows (recursive, vertex-clustered), labels 2..L ~ Likes/ReplyOf/etc."""
    return powerlaw_graph(
        num_vertices, num_edges, seed=seed, weighted=False, num_labels=num_labels
    )
