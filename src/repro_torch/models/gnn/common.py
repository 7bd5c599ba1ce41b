"""Shared GNN machinery: fixed-shape graph batches and segment message passing.

The port of ``repro/models/gnn/common.py``.  Message passing is explicit
gather → edge compute → segment scatter over the edge index, as in the
reference (``jax.ops.segment_{sum,max,min}``): sums are ``index_add``,
max/min are ``scatter_reduce(..., include_self=False)`` on a base of the
reduction's identity, so an empty segment reads −inf (max) or +inf (min) as
JAX's does.  Every scatter is out of place, so autograd gives the backward
(max/min split a tie's gradient evenly among the tied entries, as JAX does).
Graphs are padded to static (N, E): padded edges point at node 0 and are
masked; padded nodes carry zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.engine import resolve_device

Tensor = torch.Tensor


class GraphBatch(NamedTuple):
    """Fixed-shape (possibly block-diagonal batched) graph."""

    node_feat: Tensor  # f32 [N, F]
    edge_src: Tensor  # int64 [E]
    edge_dst: Tensor  # int64 [E]
    edge_feat: Tensor  # f32 [E, Fe] (zeros if unused)
    node_mask: Tensor  # bool [N]
    edge_mask: Tensor  # bool [E]
    pos: Tensor  # f32 [N, 3] (zeros for non-geometric graphs)
    labels: Tensor  # int64 [N] node labels (or graph labels scattered to node 0)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(*(t.to(device) for t in self))


def batch_from_numpy(node_feat, edge_src, edge_dst, edge_feat, node_mask, edge_mask, pos, labels,
                     device=None) -> GraphBatch:
    """A :class:`GraphBatch` from host arrays: features and positions as
    float32, indices and labels as int64, masks as bool, on ``device``
    (default: the CUDA device)."""
    dev = resolve_device(device)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
    i = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(dev)  # noqa: E731
    b = lambda x: torch.from_numpy(np.asarray(x, bool)).to(dev)  # noqa: E731
    return GraphBatch(f(node_feat), i(edge_src), i(edge_dst), f(edge_feat), b(node_mask), b(edge_mask),
                      f(pos), i(labels))


def gather(x: Tensor, index: Tensor, dim: int = 0) -> Tensor:
    """``x`` at ``index`` along ``dim`` (``x[index]``).  ``index_select``,
    whose backward is one ``index_add`` (atomic adds on the card): the
    backward of ``x[index]`` sorts the indices and adds each run of equal
    ones in one thread, which took 1.8 s of a DimeNet step on the H100,
    where every padded triplet reads edge 0 (PERF.md §6)."""
    return torch.index_select(x, dim, index)


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids, data)


def _segment_extremum(data: Tensor, segment_ids: Tensor, num_segments: int, reduce: str) -> Tensor:
    ident = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((num_segments,) + tuple(data.shape[1:]), ident, dtype=data.dtype, device=data.device)
    idx = segment_ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce, include_self=False)


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Per-segment max; −inf on an empty segment (JAX's identity)."""
    return _segment_extremum(data, segment_ids, num_segments, "amax")


def segment_min(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """Per-segment min; +inf on an empty segment (JAX's identity)."""
    return _segment_extremum(data, segment_ids, num_segments, "amin")


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    n = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype, device=data.device), segment_ids,
                    num_segments)
    n = torch.clamp(n, min=1.0)
    return s / n[..., None] if data.ndim > 1 else s / n


def degrees(edge_dst: Tensor, edge_mask: Tensor, num_nodes: int) -> Tensor:
    ones = edge_mask.to(torch.float32)
    return segment_sum(ones, edge_dst, num_nodes)


def mlp(x: Tensor, ws: list[Tensor], bs: list[Tensor], act=torch.relu) -> Tensor:
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = act(x)
    return x


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float = 1e-5) -> Tensor:
    """The reference's hand-written layer norm (``pna._layer_norm``,
    ``gatedgcn._ln``), term for term."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def random_graph_batch(
    rng: np.random.Generator,
    num_nodes: int,
    num_edges: int,
    feat_dim: int,
    *,
    edge_feat_dim: int = 0,
    num_classes: int = 8,
    geometric: bool = False,
    device=None,
) -> GraphBatch:
    """Synthetic padded graph for smoke tests: the reference's draws from
    ``rng`` in the reference's order, so one ``rng`` state gives both
    packages equal inputs."""
    src = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    dst = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    node_feat = rng.standard_normal((num_nodes, feat_dim))
    edge_feat = rng.standard_normal((num_edges, max(edge_feat_dim, 1)))
    pos = rng.standard_normal((num_nodes, 3)) if geometric else np.zeros((num_nodes, 3))
    labels = rng.integers(0, num_classes, num_nodes)
    return batch_from_numpy(node_feat, src, dst, edge_feat, np.ones(num_nodes, bool),
                            np.ones(num_edges, bool), pos, labels, device=device)


def node_classification_loss(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    """Masked mean cross-entropy.  A label outside ``[0, classes)`` reads a
    NaN logit, as the reference's ``take_along_axis`` fills it."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    inside = (labels >= 0) & (labels < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, labels, 0)[:, None])[:, 0]
    gold = torch.where(inside, gold, float("nan"))
    m = mask.to(torch.float32)
    per = (logz - gold) * m
    return per.sum() / torch.clamp(m.sum(), min=1.0)


def remat(fn, *args):
    """``jax.checkpoint``: ``fn(*args)`` keeping only its inputs for the
    backward, which runs ``fn`` again (no RNG inside, so no RNG state is
    saved).  Without autograd it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
