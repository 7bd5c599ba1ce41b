"""Shared cell builders for the GNN architectures: the port of
``repro/configs/gnn_harness.py``.

Shapes (assigned):
  full_graph_sm   N=2,708  E=10,556  d_feat=1,433   full-batch train
  minibatch_lg    base graph N=232,965 E=114.6M; sampled subgraph of
                  batch_nodes=1,024 seeds, fanout 15-10 → padded
                  (N=180,224, E=169,984) per step (real sampler: data/sampler)
  ogb_products    N=2,449,029  E=61,859,140  d_feat=100  full-batch-large
  molecule        128 graphs × (30 nodes, 64 edges), block-diagonal batch

Geometric archs (dimenet, equiformer-v2) take positions for every shape;
non-geometric shapes get synthesized coordinates.  DimeNet also takes capped
triplet lists.  The reference lowers each cell on a mesh from shape structs
and shardings; the port runs its cells on one device, from the batch
builders here (:func:`graph_batch`, :func:`molecule_batch`,
:func:`sampled_batch` over :func:`uniform_base_graph`).  Sharded cells wait
for the mesh path (ROADMAP Queue 1 item 9(f)).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.common import ShapeDef, value_and_grad
from repro_torch.core.engine import resolve_device
from repro_torch.data.sampler import CSRGraph, SampledSubgraph
from repro_torch.models.gnn import common as g
from repro_torch.optim import adamw_update

GNN_SHAPES = {
    "full_graph_sm": ShapeDef("train", dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    "minibatch_lg": ShapeDef(
        "train",
        dict(
            n_nodes=180224, n_edges=169984, d_feat=602, sampled=True,
            base_nodes=232965, base_edges=114615892, batch_nodes=1024, fanout=(15, 10),
        ),
    ),
    "ogb_products": ShapeDef("train", dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    "molecule": ShapeDef("train", dict(n_nodes=3840, n_edges=8192, d_feat=16, geometric=True)),
}

# edge-chunk sizes for the memory-bounded equiformer path on big shapes
EQUIFORMER_CHUNKS = {"ogb_products": 524288, "minibatch_lg": 0, "full_graph_sm": 0, "molecule": 0}
# triplet caps for dimenet (quadratic regime must be bounded)
DIMENET_TRIPLET_CAP = {
    "full_graph_sm": 8 * 10556,
    "minibatch_lg": 4 * 169984,
    "ogb_products": 61859140,  # 1× E cap on the huge graph
    "molecule": 65536,
}
MOLECULE = dict(nodes=30, edges=64)  # one graph of the molecule shape's block-diagonal batch
EDGE_FEAT_DIM = 8


def _pad(x: int, m: int = 512) -> int:
    """Real dataset sizes (Cora 2708, ogbn-products 2449029, …) are not
    shard-divisible; pad to the 512-device LCM — padded nodes/edges are
    masked, so semantics are unchanged."""
    return -(-x // m) * m


def triplet_cap(shape_name: str) -> int:
    """DimeNet's triplet cap for a shape, padded as the reference's cell pads it."""
    return _pad(DIMENET_TRIPLET_CAP[shape_name])


def make_gnn_train_step(loss_fn):
    """``train_step(params, opt_state, *batch_args)`` → (new params, new
    optimizer state, ``{"loss", "gnorm"}``): the loss and its gradient by
    autograd (the reference's ``value_and_grad``), then AdamW at lr 1e-3."""

    def train_step(params, opt_state, *batch_args):
        loss, grads = value_and_grad(lambda p: loss_fn(p, *batch_args), params)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, lr=1e-3)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def model_flops_estimate(arch_name: str, cfg, meta: dict) -> float:
    """Analytic useful-FLOP count (global, train step ≈ 3× forward matmuls).

    2MNK per matmul; gathers/segment reductions are counted as memory, not
    compute.
    """
    n, e = meta["n_nodes"], meta["n_edges"]
    d = cfg.d_hidden
    L = getattr(cfg, "num_layers", getattr(cfg, "num_blocks", 1))
    if arch_name == "pna":
        de = cfg.d_edge
        fwd = L * (e * 2 * d * (2 * d + de + d) + n * 2 * (13 * d) * d)
        fwd += n * 2 * meta["d_feat"] * d
    elif arch_name == "gatedgcn":
        fwd = L * (3 * e + 2 * n) * 2 * d * d + n * 2 * meta["d_feat"] * d
    elif arch_name == "dimenet":
        t = meta.get("triplets", 4 * e)
        nb, nsr = cfg.n_bilinear, cfg.n_spherical * cfg.n_radial
        fwd = L * (4 * e * 2 * d * d + t * 2 * nb * (d + nsr))
    elif arch_name == "equiformer-v2":
        K = cfg.num_components
        sum_sq = sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1))
        so2 = 2 * ((cfg.l_max + 1) * d) ** 2 + sum(
            2 * 2 * ((cfg.l_max + 1 - m) * d) ** 2 for m in range(1, cfg.m_max + 1)
        )
        fwd = L * e * (2 * 2 * sum_sq * d + so2 + 2 * K * d * d)
    else:
        return 0.0
    return 3.0 * float(fwd)  # fwd + bwd ≈ 3× forward


# ------------------------------------------------------------------ batches
def _normal(shape, generator, dev) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)


def _randint(high: int, shape, generator, dev) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator, device=dev)


def graph_batch(meta: dict, *, num_classes: int, geometric: bool, generator: torch.Generator,
                device=None) -> g.GraphBatch:
    """A full-batch shape (``full_graph_sm``, ``ogb_products``): the shape's
    nodes and edges at their real counts, padded to :func:`_pad`; edges
    uniform over the real nodes, features and edge features ``N(0, 1)``,
    labels uniform in ``[0, num_classes)``, positions ``N(0, 1)`` where the
    arch is geometric (else zeros), all drawn from ``generator``.  Padded
    edges point at node 0 and are masked; padded nodes are zeros."""
    dev = resolve_device(device)
    n0, e0, f = meta["n_nodes"], meta["n_edges"], meta["d_feat"]
    n, e = _pad(n0), _pad(e0)
    node_mask = torch.arange(n, device=dev) < n0
    edge_mask = torch.arange(e, device=dev) < e0
    src = torch.where(edge_mask, _randint(n0, (e,), generator, dev), 0)
    dst = torch.where(edge_mask, _randint(n0, (e,), generator, dev), 0)
    feat = _normal((n, f), generator, dev) * node_mask[:, None]
    efeat = _normal((e, EDGE_FEAT_DIM), generator, dev) * edge_mask[:, None]
    pos = _normal((n, 3), generator, dev) * node_mask[:, None] if geometric else torch.zeros((n, 3), device=dev)
    labels = torch.where(node_mask, _randint(num_classes, (n,), generator, dev), 0)
    return g.GraphBatch(feat, src, dst, efeat, node_mask, edge_mask, pos, labels)


def molecule_batch(meta: dict, *, num_species: int, generator: torch.Generator, device=None) -> g.GraphBatch:
    """The ``molecule`` shape: graphs of :data:`MOLECULE`'s size side by
    side (block-diagonal; 128 at the shape's ``meta``, as many as its
    ``n_nodes`` holds), each with its edges drawn uniformly among its own
    nodes, positions ``N(0, 1)``, species labels uniform in
    ``[0, num_species)``, features ``N(0, 1)``; padded to :func:`_pad`."""
    dev = resolve_device(device)
    per_n, per_e = MOLECULE["nodes"], MOLECULE["edges"]
    graphs = meta["n_nodes"] // per_n
    n0, e0 = graphs * per_n, graphs * per_e
    if (n0, e0) != (meta["n_nodes"], meta["n_edges"]):
        raise ValueError(f"{meta} is not whole graphs of {per_n} nodes and {per_e} edges")
    n, e = _pad(n0), _pad(e0)
    base = torch.arange(graphs, device=dev).repeat_interleave(per_e) * per_n
    src = torch.zeros(e, dtype=torch.long, device=dev)
    dst = torch.zeros(e, dtype=torch.long, device=dev)
    src[:e0] = base + _randint(per_n, (e0,), generator, dev)
    dst[:e0] = base + _randint(per_n, (e0,), generator, dev)
    node_mask = torch.arange(n, device=dev) < n0
    edge_mask = torch.arange(e, device=dev) < e0
    feat = _normal((n, meta["d_feat"]), generator, dev) * node_mask[:, None]
    efeat = _normal((e, EDGE_FEAT_DIM), generator, dev) * edge_mask[:, None]
    pos = _normal((n, 3), generator, dev) * node_mask[:, None]
    labels = torch.where(node_mask, _randint(num_species, (n,), generator, dev), 0)
    return g.GraphBatch(feat, src, dst, efeat, node_mask, edge_mask, pos, labels)


def uniform_base_graph(num_nodes: int, num_edges: int, rng: np.random.Generator) -> CSRGraph:
    """A uniform random directed graph as CSR, built without a sort: the
    out-degrees are one multinomial draw and each edge's head is uniform,
    the distribution of ``num_edges`` uniform (src, dst) pairs grouped by
    src."""
    deg = rng.multinomial(num_edges, np.full(num_nodes, 1.0 / num_nodes))
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    return CSRGraph(indptr=indptr, indices=indices, num_nodes=num_nodes)


def sampled_batch(sub: SampledSubgraph, features: torch.Tensor, labels: torch.Tensor,
                  pos: torch.Tensor | None, *, generator: torch.Generator) -> g.GraphBatch:
    """A ``minibatch_lg`` step's batch from one :func:`~repro_torch.data.
    sampler.sample_subgraph` sample: the sampled nodes' rows of the base
    graph's ``features``, ``labels`` and ``pos`` (zeros where ``pos`` is
    None), gathered on their device; edge features ``N(0, 1)`` from
    ``generator``; padded nodes and edges zero and masked."""
    dev = features.device
    ids = torch.from_numpy(sub.node_ids.astype(np.int64)).to(dev)
    node_mask = torch.from_numpy(sub.node_mask).to(dev)
    edge_mask = torch.from_numpy(sub.edge_mask).to(dev)
    safe = torch.clamp(ids, min=0)
    feat = features[safe] * node_mask[:, None]
    lab = torch.where(node_mask, labels[safe], 0)
    p = pos[safe] * node_mask[:, None] if pos is not None else torch.zeros((ids.shape[0], 3), device=dev)
    efeat = _normal((edge_mask.shape[0], EDGE_FEAT_DIM), generator, dev) * edge_mask[:, None]
    src = torch.from_numpy(sub.edge_src.astype(np.int64)).to(dev)
    dst = torch.from_numpy(sub.edge_dst.astype(np.int64)).to(dev)
    return g.GraphBatch(feat, src, dst, efeat, node_mask, edge_mask, p, lab)
