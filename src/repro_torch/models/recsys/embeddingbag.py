"""EmbeddingBag: gather the bag's rows from a table and reduce each bag.

The port of ``repro/models/recsys/embeddingbag.py``: lookups are plain
index gathers, a fixed-length bag reduces over its axis, a ragged bag sums
by ``index_add_`` over its bag id (the reference's ``segment_sum``).  No
path calls these, in the reference or here (MIND gathers directly); they
are ported for completeness.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def embedding_bag_fixed(
    table: Tensor,  # [R, D]
    indices: Tensor,  # int [B, L]  fixed-length bags
    weights: Tensor | None = None,  # [B, L] per-item weights
    *,
    mode: str = "sum",
    valid: Tensor | None = None,  # bool [B, L] padding mask
) -> Tensor:
    """Fixed-length-bag lookup: gather [B, L, D] → reduce L. [B, D]"""
    emb = table[indices]  # [B, L, D]
    if weights is not None:
        emb = emb * weights[..., None]
    if valid is not None:
        emb = torch.where(valid[..., None], emb, 0.0)
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        if valid is not None:
            n = valid.sum(dim=1, keepdim=True).to(emb.dtype)
        else:
            n = torch.tensor(float(indices.shape[1]), dtype=torch.float32, device=emb.device)
        return emb.sum(dim=1) / torch.clamp(n, min=1.0)
    raise ValueError(mode)


def embedding_bag_ragged(
    table: Tensor,  # [R, D]
    indices: Tensor,  # int [T] flattened item ids
    bag_ids: Tensor,  # int [T] which bag each item belongs to
    num_bags: int,
    *,
    mode: str = "sum",
) -> Tensor:
    """Ragged bags summed by bag id (CSR-style offsets → bag_ids). [B, D]"""
    emb = table[indices]  # [T, D]
    s = torch.zeros((num_bags, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    s.index_add_(0, bag_ids, emb)
    if mode == "sum":
        return s
    n = torch.zeros((num_bags,), dtype=emb.dtype, device=emb.device)
    n.index_add_(0, bag_ids, torch.ones_like(bag_ids, dtype=emb.dtype))
    return s / torch.clamp(n, min=1.0)[:, None]
