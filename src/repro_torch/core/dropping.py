"""Partial difference dropping (paper §5): Det-Drop, Prob-Drop, selection.

The port of ``repro/core/dropping.py``.  Two components, as in the paper:

* **Dropped-difference maintenance** — a deterministic dense store of
  (vertex, iteration) pairs (Det-Drop: sorted rows like the diff store,
  iteration-only, ~4 bytes per dropped diff), or a Bloom filter (Prob-Drop,
  fixed footprint).
* **Selection** — Random (Bernoulli p) or Degree (τ_min / τ_max / p,
  §5.2.1), decided by a stateless hash of (seed, query, vertex, iteration),
  so drop sets are reproducible.

Selection parameters are per query (``[Q]`` rows in :class:`DropParams`);
the DroppedVT representation and its capacities are session-level.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import bloom as bloom_lib
from repro_torch.core import diffstore as ds
from repro_torch.kernels.diff_lookup import diff_lookup

Tensor = torch.Tensor

# Accounted bytes of one query's DropParams row: p (f32) + tau_min (f32) +
# tau_max (f32) + degree_sel (1 B) + seed (u32).
PARAMS_ROW_NBYTES = 17

@dataclasses.dataclass(frozen=True)
class DropConfig:
    mode: str = "none"  # none | det | prob
    selection: str = "random"  # random | degree
    p: float = 0.0  # drop probability
    tau_min: float = 2.0  # drop everything below (degree policy)
    tau_max: float = float("inf")  # keep everything above (80th pctile)
    det_capacity: int = 32  # S_d (Det-Drop slots per vertex)
    bloom_bits: int = 1 << 16  # per-query filter bits
    bloom_hashes: int = 4
    seed: int = 0

    def enabled(self) -> bool:
        return self.mode != "none"

    def drops_all(self) -> bool:
        """True when this policy selects EVERY candidate difference —
        complete dropping (§4): p ≥ 1 under Random, or p ≥ 1 with no τ_max
        carve-out under Degree."""
        return self.enabled() and self.p >= 1.0 and (
            self.selection == "random" or self.tau_max == float("inf")
        )


class DropParams(NamedTuple):
    """Per-query selection parameters (``[Q]`` tensors).

    ``degree_sel`` encodes the selection strategy (False = Random, True =
    Degree).  ``seed`` holds uint32 values in int64: torch's uint32 has
    little arithmetic, and the selection hash wraps at 32 bits explicitly.
    """

    p: Tensor  # f32 [Q] — drop probability
    tau_min: Tensor  # f32 [Q] — degree policy: drop everything below
    tau_max: Tensor  # f32 [Q] — degree policy: keep everything above
    degree_sel: Tensor  # bool [Q] — True = Degree selection, False = Random
    seed: Tensor  # int64 [Q] — per-query hash seed (uint32 range)


def _check_selection(cfg: DropConfig) -> bool:
    if cfg.selection not in ("random", "degree"):
        raise ValueError(f"unknown selection {cfg.selection!r}")
    return cfg.selection == "degree"


def params_row(cfg: DropConfig) -> tuple[float, float, float, bool, int]:
    """One query's selection parameters from its :class:`DropConfig`.

    A disabled config maps to the never-drop row (Random with p = 0).
    """
    degree_sel = _check_selection(cfg)
    if not cfg.enabled():
        return (0.0, 0.0, float("inf"), False, int(cfg.seed))
    return (cfg.p, cfg.tau_min, cfg.tau_max, degree_sel, int(cfg.seed))


def make_params(
    configs: "list[DropConfig] | DropConfig",
    num_queries: int | None = None,
    device=None,
) -> DropParams:
    """Stack per-query configs into :class:`DropParams` tensors; a single
    config broadcasts over ``num_queries``."""
    if isinstance(configs, DropConfig):
        if num_queries is None:
            raise ValueError("a single DropConfig needs num_queries")
        configs = [configs] * num_queries
    p, tmin, tmax, sel, seed = zip(*(params_row(c) for c in configs))
    return DropParams(
        p=torch.tensor(p, dtype=torch.float32, device=device),
        tau_min=torch.tensor(tmin, dtype=torch.float32, device=device),
        tau_max=torch.tensor(tmax, dtype=torch.float32, device=device),
        degree_sel=torch.tensor(sel, dtype=torch.bool, device=device),
        seed=torch.tensor(seed, dtype=torch.int64, device=device) & bloom_lib.M32,
    )


def set_params_row(params: DropParams, q: int, cfg: DropConfig) -> DropParams:
    """Return ``params`` with query ``q``'s row replaced by ``cfg``."""
    row = params_row(cfg)
    out = []
    for field, value in zip(DropParams._fields, row):
        t = getattr(params, field).clone()
        t[q] = value & bloom_lib.M32 if field == "seed" else value
        out.append(t)
    return DropParams(*out)


class DropState(NamedTuple):
    """DroppedVT — tracks dropped (vertex, iteration) pairs."""

    det: ds.DiffStore | None  # iters used; vals stay zero
    flt: bloom_lib.BloomFilter | None
    det_overflow: Tensor  # int32 — det evictions that lost a dropped VT
    max_iter: Tensor  # int32 — highest iteration ever dropped (horizon term)
    params: DropParams | None = None  # per-query selection ([Q] rows)

    def nbytes_accounted(self, active: Tensor | None = None) -> int:
        """Accounted DroppedVT bytes (paper §5.1 costings): 4 B per Det
        record, or the packed filter (M/8 B) per live query row, plus
        :data:`PARAMS_ROW_NBYTES` per live query for the selection rows.
        ``active`` is the live-slot mask (default: every row counts)."""
        def live_rows(rows: Tensor) -> int:
            return int(rows.shape[0]) if active is None else int(active.to(torch.bool).sum())

        total = 0
        if self.params is not None:
            total += live_rows(self.params.p) * PARAMS_ROW_NBYTES
        if self.det is not None:
            return total + int(self.det.count.sum()) * 4  # d bytes per dropped VT
        if self.flt is None:
            raise ValueError("nbytes_accounted of a disabled DroppedVT")
        return total + live_rows(self.flt.bits) * ((self.flt.num_bits + 7) // 8)


def make_state(
    cfg: DropConfig,
    num_queries: int,
    num_keys: int,
    per_query: "list[DropConfig] | None" = None,
    device=None,
) -> DropState:
    """DroppedVT state for ``num_queries`` slots.

    ``cfg`` fixes the representation (mode, capacities); ``per_query``
    optionally supplies each slot's selection parameters (default: ``cfg``
    broadcast).
    """
    if cfg.mode not in ("none", "det", "prob"):
        raise ValueError(f"unknown drop mode {cfg.mode!r}")
    z = torch.zeros((), dtype=torch.int32, device=device)
    neg = torch.full((), -1, dtype=torch.int32, device=device)
    if not cfg.enabled():
        return DropState(det=None, flt=None, det_overflow=z, max_iter=neg)
    params = make_params(per_query if per_query is not None else cfg, num_queries, device=device)
    if cfg.mode == "det":
        det = ds.make((num_queries, num_keys), cfg.det_capacity, device=device)
        return DropState(det=det, flt=None, det_overflow=z, max_iter=neg, params=params)
    flt = bloom_lib.make((num_queries,), cfg.bloom_bits, cfg.bloom_hashes, device=device)
    return DropState(det=None, flt=flt, det_overflow=z, max_iter=neg, params=params)


def _uniform01(seed, q, v, i) -> Tensor:
    """Deterministic per-(seed, q, v, i) uniform in [0, 1).

    The uint32 hash converts to float32 with round-to-nearest and is then
    divided by 2**32, as the reference's ``astype(float32) / 2**32``: a hash
    of ``0xFFFFFFFF`` rounds to 2**32 and reads 1.0.
    """
    u, m32, mix = bloom_lib.u32, bloom_lib.M32, bloom_lib._mix
    h = mix(u(v) ^ mix((u(i) * 0x9E3779B9) & m32) ^ mix((u(q) + u(seed)) & m32))
    return h.to(torch.float32) / float(2**32)


def select_to_drop(params: DropParams, degree: Tensor, q, v, i) -> Tensor:
    """Which candidate differences to drop (paper §5.2, Fig. 3).

    ``degree`` (f32, the vertex's total degree) broadcasts against q/v/i;
    the per-query rows of ``params`` broadcast over the vertex axis.
    """
    u = _uniform01(params.seed[:, None], q, v, i)
    coin = u < params.p[:, None]
    by_degree = torch.where(
        degree < params.tau_min[:, None],
        True,
        torch.where(degree > params.tau_max[:, None], False, coin),
    )
    return torch.where(params.degree_sel[:, None], by_degree, coin)


def select_stored_to_drop(
    params: DropParams, degree: Tensor, iters: Tensor, imax: int, q_ids=None, v_offset: int = 0
) -> Tensor:
    """Which *stored* change points to shed under the current params. [Q,V,S]

    The governor escalates a query's policy mid-stream; the stored diffs
    are re-audited with the same stateless coin the sweep uses —
    ``_uniform01(seed, q, v, i)`` — so a shed drops exactly the points the
    escalated policy would have dropped at write time.  ``iters`` is the
    diff-store iteration tensor; entries padded with ``imax`` never select.
    ``q_ids`` are the query slots of ``iters``' rows (default: 0..Q-1), so
    one slot's row, with its row of ``params``, is audited alone.
    ``v_offset`` is the global id of ``iters``' first vertex (a shard's
    block): the coin sees global ids.
    """
    q, v, s = iters.shape
    dev = iters.device
    v_ids = (v_offset + torch.arange(v, dtype=torch.int32, device=dev))[None, :, None].expand(q, v, s)
    deg = degree.to(torch.float32)[None, :, None].expand(q, v, s)
    if q_ids is None:
        q_ids = torch.arange(q, dtype=torch.int32, device=dev)
    q_ids = torch.as_tensor(q_ids, dtype=torch.int32, device=dev).reshape(-1, 1)
    sel = select_to_drop(
        params, deg.reshape(q, v * s), q_ids, v_ids.reshape(q, v * s), iters.reshape(q, v * s)
    )
    return sel.reshape(q, v, s) & (iters < imax)


def register(state: DropState, i, mask: Tensor, v_offset: int = 0) -> DropState:
    """Record dropped VT pairs (v, i) where ``mask`` [Q, V].

    ``i`` is a scalar iteration or a per-(q, v) int32 tensor (evictions drop
    each row's own oldest iteration).  The Bloom key is the vertex id and
    the iteration, salted by the query slot index.  ``v_offset`` maps the
    mask's vertex axis to global ids (a shard registers its own block,
    hashed by global id, so the bits do not depend on the sharding).
    """
    hi = torch.where(mask, torch.as_tensor(i, dtype=torch.int32, device=mask.device), -1).max()
    max_iter = torch.maximum(state.max_iter, hi)
    if state.det is not None:
        zeros = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        det, evicted, _ = ds.upsert(state.det, i, mask, zeros)
        overflow = state.det_overflow + evicted.sum(dtype=torch.int32)
        return state._replace(det=det, det_overflow=overflow, max_iter=max_iter)
    if state.flt is not None:
        qn, vn = mask.shape
        v_ids = (v_offset + torch.arange(vn, dtype=torch.int32, device=mask.device))[None, :]
        salt = torch.arange(qn, dtype=torch.int32, device=mask.device)[:, None]
        flt = bloom_lib.insert(state.flt, v_ids, i, mask, salt=salt)
        return state._replace(flt=flt, max_iter=max_iter)
    return state


def register_(state: DropState, i, mask: Tensor, q_offset: int = 0, v_offset: int = 0) -> DropState:
    """:func:`register` written into the Det store (only its marked rows,
    :func:`diffstore.upsert_rows_`) or the Bloom bits in place; returns the
    state with ``det_overflow`` and ``max_iter`` advanced.  ``q_offset`` is
    the query slot of ``mask``'s first row (the Bloom salt), so a view of
    one slot's rows registers as that slot; ``v_offset`` as for
    :func:`register`."""
    hi = torch.where(mask, torch.as_tensor(i, dtype=torch.int32, device=mask.device), -1).max()
    state = state._replace(max_iter=torch.maximum(state.max_iter, hi))
    if state.det is not None:
        zeros = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        evicted = ds.upsert_rows_(state.det, i, mask, zeros)
        return state._replace(det_overflow=state.det_overflow + evicted)
    if state.flt is not None:
        qn, vn = mask.shape
        v_ids = (v_offset + torch.arange(vn, dtype=torch.int32, device=mask.device))[None, :]
        salt = q_offset + torch.arange(qn, dtype=torch.int32, device=mask.device)[:, None]
        bloom_lib.insert_(state.flt, v_ids, i, mask, salt=salt)
    return state


def unregister(state: DropState, i, mask: Tensor) -> DropState:
    """Remove dropped records at (v, i) — only possible deterministically;
    a Bloom filter cannot delete, and its stale positives are harmless."""
    if state.det is not None:
        return state._replace(det=ds.remove_at(state.det, i, mask))
    return state


def dropped_at(state: DropState, i: int, num_vertices: int, v_offset: int = 0) -> Tensor:
    """Mask [Q, V]: was a diff for (v, i) dropped? (Prob: may false-positive.)

    ``num_vertices`` is the extent of the (possibly shard-local) vertex
    axis; ``v_offset`` shifts it to global ids for the Bloom probe.
    """
    if state.det is not None:
        return ds.has_at(state.det, i)
    if state.flt is not None:
        qn = state.flt.bits.shape[0]
        dev = state.flt.bits.device
        v_ids = (v_offset + torch.arange(num_vertices, dtype=torch.int32, device=dev))[None, :]
        salt = torch.arange(qn, dtype=torch.int32, device=dev)[:, None]
        return bloom_lib.query(state.flt, v_ids, i, salt=salt)
    raise ValueError("dropped_at called with dropping disabled")


def latest_dropped_le(state: DropState, i: int, num_vertices: int) -> tuple[Tensor, Tensor]:
    """(found, iter) [Q, V] of the latest dropped VT at iteration ≤ i.

    Paper's AccessDᵢᵛWithDrops step 2.  Det-Drop looks the sorted Det rows
    up through the ``diff_lookup`` kernel (``[Q·V, S_d]`` rows, scalar i);
    Prob-Drop probes every iteration from i down to 0 (§5.1.2) and takes
    the highest hit.
    """
    if state.det is not None:
        q, v, s = state.det.iters.shape
        _, it, found = diff_lookup(state.det.iters.reshape(q * v, s), state.det.vals.reshape(q * v, s), i)
        return found.view(q, v), it.view(q, v)
    if state.flt is not None:
        hits = torch.stack([dropped_at(state, j, num_vertices) for j in range(i + 1)], dim=-1)
        found = hits.any(dim=-1)
        last = i - torch.argmax(hits.flip(-1).to(torch.uint8), dim=-1)  # highest j with a hit
        return found, torch.where(found, last, -1).to(torch.int32)
    raise ValueError("dropping disabled")
