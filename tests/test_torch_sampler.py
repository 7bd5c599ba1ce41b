"""Port parity: the host data paths of GNN training, numpy only.

``build_triplets`` (DimeNet's, as array passes), ``CSRGraph.from_edges``
(counting with ``np.bincount``), ``sample_subgraph``, ``lm_batch`` and
``mind_batch`` against the reference's on the same inputs and ``rng``
states, each bit-equal (values and dtypes).  The harness's base graph and
batch builders are checked for their shapes, masks and the distribution
they claim.  Last, the Diff-IFE sampler index: the reference's
``examples/incremental_gnn_sampling.py`` flow replayed with the port's
``queries.khop`` / ``khop_reachable`` and ``data.sampler``, every sampled
node inside the maintained 2-hop frontiers, and each batch's ``scheduled``
and sample equal to the reference's.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import gnn_harness as H
from repro_torch.data import sampler as S
from repro_torch.data import synthetic as SY
from repro_torch.models.gnn import dimenet


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


def _graph(seed, n, e, masked=0.2, dup=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if dup and e > 3:
        src[1], dst[1] = src[0], dst[0]  # a repeated edge
        src[2], dst[2] = dst[0], src[0]  # and its reverse (a k == i backtrack)
    mask = rng.random(e) >= masked
    return src, dst, mask


@pytest.mark.parametrize("seed,n,e,cap", [(0, 48, 160, 1024), (1, 48, 160, 37), (2, 20, 200, 1),
                                          (3, 300, 1500, 4096), (4, 5, 0, 16), (5, 64, 256, 0),
                                          (8, 64, 256, 0)])
def test_build_triplets_is_bit_equal_to_the_reference(seed, n, e, cap):
    from repro.models.gnn import dimenet as rd

    src, dst, mask = _graph(seed, n, e)
    want = rd.build_triplets(src, dst, mask, cap)
    got = dimenet.build_triplets(src, dst, mask, cap)
    for a, b in zip(got, want):
        _same(a, b)


def test_build_triplets_across_blocks_of_edges():
    """More live edges than one block of the array passes (2^16)."""
    from repro.models.gnn import dimenet as rd

    src, dst, mask = _graph(6, 20000, 70000, masked=0.1)
    for cap in (300000, 50000):
        for a, b in zip(dimenet.build_triplets(src, dst, mask, cap), rd.build_triplets(src, dst, mask, cap)):
            _same(a, b)


@pytest.mark.parametrize("seed,n,e", [(0, 30, 100), (1, 1000, 5000), (2, 7, 0)])
def test_csr_from_edges_is_bit_equal_to_the_reference(seed, n, e):
    from repro.data import sampler as rs

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    got, want = S.CSRGraph.from_edges(src, dst, n), rs.CSRGraph.from_edges(src, dst, n)
    _same(got.indptr, want.indptr)
    _same(got.indices, want.indices)
    assert got.num_nodes == want.num_nodes
    for v in range(min(n, 5)):
        _same(got.neighbors(v), want.neighbors(v))


@pytest.mark.parametrize("fanouts,max_nodes,max_edges", [((15, 10), 4096, 4096), ((5, 3), 128, 256),
                                                        ((4, 4, 4), 40, 60)])
def test_sample_subgraph_is_bit_equal_to_the_reference(fanouts, max_nodes, max_edges):
    from repro.data import sampler as rs

    rng = np.random.default_rng(9)
    n, e = 500, 6000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    seeds = rng.choice(n, 16, replace=False)
    got = S.sample_subgraph(S.CSRGraph.from_edges(src, dst, n), seeds, fanouts, max_nodes=max_nodes,
                            max_edges=max_edges, rng=np.random.default_rng(3))
    want = rs.sample_subgraph(rs.CSRGraph.from_edges(src, dst, n), seeds, fanouts, max_nodes=max_nodes,
                              max_edges=max_edges, rng=np.random.default_rng(3))
    for f in ("node_ids", "edge_src", "edge_dst", "node_mask", "edge_mask"):
        _same(getattr(got, f), getattr(want, f))
    assert got.num_seeds == want.num_seeds == 16


def test_synthetic_batches_are_bit_equal_to_the_reference():
    from repro.data import synthetic as rsy

    for step in (0, 7):
        for a, b in zip(SY.lm_batch(step, batch=3, seq_len=9, vocab=100, seed=2),
                        rsy.lm_batch(step, batch=3, seq_len=9, vocab=100, seed=2)):
            _same(a, b)
        for a, b in zip(SY.mind_batch(step, batch=4, seq_len=6, num_items=50),
                        rsy.mind_batch(step, batch=4, seq_len=6, num_items=50)):
            _same(a, b)


def test_harness_batches_have_the_shapes_padding_and_distribution():
    gen = torch.Generator().manual_seed(0)
    meta = dict(n_nodes=700, n_edges=1500, d_feat=12)
    b = H.graph_batch(meta, num_classes=5, geometric=True, generator=gen, device="cpu")
    assert (b.num_nodes, b.num_edges) == (1024, 1536) and b.node_feat.shape == (1024, 12)
    assert int(b.node_mask.sum()) == 700 and int(b.edge_mask.sum()) == 1500
    assert int(b.edge_src.max()) < 700 and int(b.labels.max()) < 5
    assert not b.node_feat[700:].any() and not b.pos[700:].any() and not b.edge_src[1500:].any()
    m = H.molecule_batch(H.GNN_SHAPES["molecule"].meta, num_species=16, generator=gen, device="cpu")
    assert (m.num_nodes, m.num_edges) == (4096, 8192)
    graph_of = lambda x: x[:8192] // 30  # noqa: E731
    assert torch.equal(graph_of(m.edge_src), graph_of(m.edge_dst))  # block-diagonal
    assert torch.equal(graph_of(m.edge_src), torch.arange(128).repeat_interleave(64))
    rng = np.random.default_rng(0)
    csr = H.uniform_base_graph(1000, 50000, rng)
    assert csr.indptr[0] == 0 and csr.indptr[-1] == 50000 and np.all(np.diff(csr.indptr) >= 0)
    deg = np.diff(csr.indptr)
    assert abs(deg.mean() - 50) < 1e-9 and 0.5 < deg.std() / np.sqrt(50) < 1.5  # binomial spread
    feats, labels = torch.randn(1000, 6, generator=gen), torch.randint(0, 7, (1000,), generator=gen)
    sub = S.sample_subgraph(csr, np.arange(8), (5, 3), max_nodes=80, max_edges=64, rng=rng)
    sb = H.sampled_batch(sub, feats, labels, None, generator=gen)
    n = int(sub.node_mask.sum())
    assert torch.equal(sb.node_feat[:n], feats[torch.from_numpy(sub.node_ids[:n]).long()])
    assert not sb.node_feat[n:].any() and not sb.pos.any() and sb.edge_feat.shape == (64, 8)
    assert H.triplet_cap("minibatch_lg") == 679936 and H.triplet_cap("full_graph_sm") == 84480


def test_sampler_draws_inside_the_maintained_khop_frontiers_as_the_reference():
    """examples/incremental_gnn_sampling.py's flow on both packages."""
    from repro.core import queries as rq
    from repro.core.graph import DynamicGraph as RGraph
    from repro.data import graphgen as rgen
    from repro.data import sampler as rs
    from repro_torch.core import queries as q
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.data import graphgen

    V = 300
    edges = graphgen.powerlaw_graph(V, 1500, seed=4, weighted=False)
    assert edges == rgen.powerlaw_graph(V, 1500, seed=4, weighted=False)
    initial, pool = graphgen.split_90_10(edges, seed=4)
    stream = graphgen.update_stream(initial, V, num_batches=10, insert_pool=pool, seed=5)
    seeds = np.asarray([3, 17, 56, 81])
    khop = q.khop(DynamicGraph(V, initial, capacity=8192), [int(s) for s in seeds], k=2, device="cpu")
    rkhop = rq.khop(RGraph(V, initial, capacity=8192), [int(s) for s in seeds], k=2)
    present = list(initial)
    for i, batch in enumerate(stream):
        stats, rstats = khop.apply_updates(batch), rkhop.apply_updates(batch)
        assert int(stats.scheduled) == int(rstats.scheduled)
        reachable = q.khop_reachable(khop)
        assert np.array_equal(reachable, rq.khop_reachable(rkhop))
        for (u, v, lbl, w, s) in batch:
            if s > 0:
                present.append((u, v, 1.0))
            else:
                present = [(a, b, w_) for (a, b, w_) in present if (a, b) != (u, v)]
        src = np.asarray([e[0] for e in present], np.int32)
        dst = np.asarray([e[1] for e in present], np.int32)
        sub = S.sample_subgraph(S.CSRGraph.from_edges(src, dst, V), seeds, (5, 3), max_nodes=128,
                                max_edges=256, rng=np.random.default_rng(i))
        rsub = rs.sample_subgraph(rs.CSRGraph.from_edges(src, dst, V), seeds, (5, 3), max_nodes=128,
                                  max_edges=256, rng=np.random.default_rng(i))
        _same(sub.node_ids, rsub.node_ids)
        _same(sub.edge_src, rsub.edge_src)
        sampled = sub.node_ids[sub.node_mask]
        assert reachable[:, sampled].any(axis=0).all(), f"batch {i}: the sampler left the frontiers"
