"""Mixture-of-experts layer: top-k routing with sort-based capacity dispatch.

The port of ``repro/models/moe.py`` for one device: tokens are sorted by
expert id (a stable sort), sliced into per-expert capacity buckets ``[E, C,
d]`` (choices past an expert's capacity are dropped), pushed through three
batched expert products (``torch.bmm``, as the reference's einsums, which it
computes outside any Pallas kernel), and combined back with the router
gates.  Every shape is fixed by ``T``, ``k`` and the capacity, so a step
never waits on the device for a count.

Top-k breaks ties as ``jax.lax.top_k`` does, lower expert index first: the
first ``k`` of a stable descending sort (``torch.topk`` orders ties
otherwise, and bfloat16 router logits tie often).

:func:`moe_ffn`'s parts run under profiler ranges (``moe.dispatch``,
``moe.experts``, ``moe.combine``, ``moe.aux``; :func:`common.profile_range`),
so a profiled step splits its device time by part.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as cm

Tensor = torch.Tensor


def topk_routing(logits: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """logits [T, E] → (gates [T, k] softmaxed over the top-k in float32,
    idx [T, k]), ties to the lower index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k].float(), dim=-1)
    return gates, idx[..., :k]


def dispatch_indices(idx: Tensor, num_experts: int, capacity: int) -> Tensor:
    """Per-(token, choice) slot ``[T*k]`` int32 in ``[0, E*C)``, or -1 where
    the choice is dropped: a stable sort by expert id, the rank within each
    expert's group (index minus the group's start), ranks >= C dropped."""
    tk = idx.numel()
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)  # token-choice ids sorted by expert
    sorted_e = flat[order]
    experts = torch.arange(num_experts, dtype=sorted_e.dtype, device=idx.device)
    group_start = torch.searchsorted(sorted_e, experts, side="left")
    rank = torch.arange(tk, device=idx.device) - group_start[sorted_e]
    slot_sorted = torch.where(rank < capacity, sorted_e * capacity + rank, -1)
    # scatter back to token-choice order
    slot = torch.zeros((tk,), dtype=torch.int32, device=idx.device)
    slot[order] = slot_sorted.to(torch.int32)
    return slot


def moe_ffn(
    x: Tensor,  # [T, d] tokens
    router_w: Tensor,  # [d, E_pad]
    we_g: Tensor,  # [E_pad, d, f]
    we_i: Tensor,  # [E_pad, d, f]
    we_o: Tensor,  # [E_pad, f, d]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    num_experts: int | None = None,  # logical count; E_pad - E are padding
) -> tuple[Tensor, Tensor]:
    """Returns (output [T, d], the Switch-style load-balancing aux loss).
    Router logits of the padded experts are masked to ``-1e30``, so they
    never receive a token."""
    t, d = x.shape
    e = router_w.shape[-1]  # padded
    e_logical = num_experts or e
    with cm.profile_range("moe.dispatch"):
        logits = (x @ router_w).float()
        if e_logical < e:
            logits = torch.where(torch.arange(e, device=x.device) < e_logical, logits, -1e30)
        gates, idx = topk_routing(logits, top_k)  # [T, k]
        capacity = max(1, int(capacity_factor * t * top_k / e_logical))
        slot = dispatch_indices(idx, e, capacity)  # [T*k]
        valid = slot >= 0
        # dropped choices target a sacrificial trailing row (sliced off
        # below) so they can never clobber slot 0
        safe_slot = torch.where(valid, slot, e * capacity)
        buf = x.new_zeros((e * capacity + 1, d))
        buf[safe_slot] = x.repeat_interleave(top_k, dim=0)  # [T*k, d] rows
        h = buf[:-1].reshape(e, capacity, d)
    with cm.profile_range("moe.experts"):
        # batched expert FFN (SwiGLU): silu as x * sigmoid(x), each rounded
        # to x's dtype, as jax.nn.silu
        a = torch.bmm(h, we_g)
        b = torch.bmm(h, we_i)
        y = torch.bmm(a * torch.sigmoid(a) * b, we_o).reshape(e * capacity, d)
    with cm.profile_range("moe.combine"):
        # gather each choice's slot output, weight it by its gate
        yk = y[torch.where(valid, slot, 0)] * valid[:, None]  # [T*k, d]
        out = (yk.reshape(t, top_k, d) * gates[..., None].to(x.dtype)).sum(dim=1)
    with cm.profile_range("moe.aux"):
        me = torch.softmax(logits, dim=-1).mean(dim=0)  # [E_pad]
        ce = torch.zeros((e,), dtype=torch.float32, device=x.device)
        ce.index_add_(0, idx.reshape(-1), torch.ones((t * top_k,), dtype=torch.float32, device=x.device))
        aux = e_logical * torch.sum(me * (ce / (t * top_k)))
    return out.to(x.dtype), aux
