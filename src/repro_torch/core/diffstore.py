"""Dense difference store — the paper's eager-merged δD index as tensors.

After eager merging (§4.2) timestamps are one-dimensional (IFE iteration) and
negative multiplicities are implied, so each key holds a sorted list of
``(iteration, state)`` *change points*, kept as fixed-capacity sorted rows of
a dense tensor so every operation vectorizes over all (query, key) pairs:

    iters : int32  [..., S]   sorted ascending, padded with IMAX
    vals  : f32    [..., S]
    count : int32  [...]

Two deliberate deviations from the paper (DESIGN.md §2): initial diffs are
implicit (a lookup that finds nothing returns the query's init), and rows
hold at most ``S`` change points — on overflow the *oldest* is evicted.

Every function is pure: it returns new tensors and leaves its inputs as they
were, so a caller can hold a store as the frozen pre-update snapshot while
the sweep builds the next one.  Storage stays int32/float32 so that byte
counts agree with the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

IMAX = 2**31 - 1  # int32 max: the padding iteration of an empty cell


class DiffStore(NamedTuple):
    iters: Tensor  # int32 [..., S]
    vals: Tensor  # float32 [..., S]
    count: Tensor  # int32 [...]

    @property
    def capacity(self) -> int:
        return int(self.iters.shape[-1])


def make(shape: tuple[int, ...], capacity: int, device=None) -> DiffStore:
    return DiffStore(
        iters=torch.full((*shape, capacity), IMAX, dtype=torch.int32, device=device),
        vals=torch.zeros((*shape, capacity), dtype=torch.float32, device=device),
        count=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def _col(i: Tensor | int):
    """``i`` broadcast against the last (capacity) axis."""
    return i[..., None] if isinstance(i, Tensor) and i.ndim else i


def _first_true(mask: Tensor) -> Tensor:
    """Index of the first True along the last axis (0 where none) — the
    first-among-ties rule of ``argmax``, which refuses bool input."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def lookup_le(store: DiffStore, i: Tensor | int) -> tuple[Tensor, Tensor, Tensor]:
    """Latest stored change point at iteration ≤ i.

    Returns ``(val, found_iter, found)``; where ``found`` is False the caller
    substitutes the implicit init state.  Padding is IMAX so a ≤-count
    reduction finds the insertion point (rows are sorted).
    """
    idx = (store.iters <= _col(i)).sum(dim=-1) - 1  # [-1 .. S-1]
    found = idx >= 0
    safe = idx.clamp(min=0)
    val = _take(store.vals, safe)
    it = _take(store.iters, safe)
    return val, torch.where(found, it, -1), found


def value_at(store: DiffStore, i: Tensor | int) -> tuple[Tensor, Tensor]:
    """(has_entry_at_i, value_at_i) for an exact iteration."""
    eq = store.iters == _col(i)
    has = eq.any(dim=-1)
    val = _take(store.vals, _first_true(eq))
    return has, val


def has_at(store: DiffStore, i: Tensor | int) -> Tensor:
    return (store.iters == _col(i)).any(dim=-1)


def _shift_left(x: Tensor, fill) -> Tensor:
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], dim=-1)


def _shift_right(x: Tensor) -> Tensor:
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def upsert(
    store: DiffStore, i: Tensor | int, write: Tensor, new_vals: Tensor
) -> tuple[DiffStore, Tensor, Tensor]:
    """Insert-or-overwrite change point ``(i, new_vals)`` where ``write``.

    Eager-merge semantics: one change point per (key, iteration); a second
    write at the same iteration overwrites.  Returns ``(store, evicted_mask,
    evicted_iter)`` — evictions happen only when a full row receives a new
    iteration and must shed its *oldest* change point.
    """
    icol = _col(i)
    s = store.capacity
    ar = torch.arange(s, device=store.iters.device)
    eq = store.iters == icol
    exists = eq.any(dim=-1)
    nv = new_vals[..., None] if new_vals.ndim == store.count.ndim else new_vals

    # --- overwrite path -------------------------------------------------
    eqidx = _first_true(eq)
    ow_vals = torch.where(
        (write & exists)[..., None] & (ar == eqidx[..., None]), nv, store.vals
    )

    # --- insert path (row may be full → evict oldest) --------------------
    ins = write & ~exists
    full = store.count >= s
    evict = ins & full
    evicted_iter = store.iters[..., 0]
    base_iters = torch.where(evict[..., None], _shift_left(store.iters, IMAX), store.iters)
    base_vals = torch.where(evict[..., None], _shift_left(store.vals, 0.0), ow_vals)
    base_count = torch.where(evict, store.count - 1, store.count)

    pos = (base_iters < icol).sum(dim=-1)
    sel_keep = ar < pos[..., None]
    sel_new = ar == pos[..., None]
    ins_iters = torch.where(
        sel_keep, base_iters, torch.where(sel_new, icol, _shift_right(base_iters))
    )
    ins_vals = torch.where(sel_keep, base_vals, torch.where(sel_new, nv, _shift_right(base_vals)))

    out_iters = torch.where(ins[..., None], ins_iters, base_iters)
    out_vals = torch.where(ins[..., None], ins_vals, base_vals)
    out_count = torch.where(ins, base_count + 1, base_count)
    return DiffStore(out_iters, out_vals, out_count), evict, evicted_iter


# rows per slice of :func:`upsert_rows_`: bounds its temporaries (each a
# few [rows, S] tensors) whatever the number of rows written
UPSERT_SLICE_ROWS = 1 << 22


def upsert_rows_(store: DiffStore, i: Tensor | int, write: Tensor, new_vals: Tensor) -> Tensor:
    """:func:`upsert` written into ``store`` in place; returns the number of
    rows that shed their oldest change point (int32, on the device), and
    keeps nothing else of the evictions.

    :func:`upsert` leaves every row whose ``write`` is False as it was, so
    only the marked rows are gathered, upserted and scattered back, in
    slices of at most :data:`UPSERT_SLICE_ROWS` rows: the result equals
    ``upsert(store, i, write, new_vals)[0]`` while the temporaries stay a
    few hundred MB even when every row is written (a sweep over a store of
    ~1.4e9 cells would otherwise build ten full-size ones).  ``write`` and
    ``new_vals`` (and ``i``, where it is a tensor of iterations per row)
    have the store's key shape; the store's tensors must be contiguous.
    """
    s = store.capacity
    iters, vals, count = store.iters.view(-1, s), store.vals.view(-1, s), store.count.view(-1)
    rows = write.reshape(-1).nonzero().squeeze(1)
    new_flat = new_vals.reshape(-1)
    i_flat = i.reshape(-1) if isinstance(i, Tensor) and i.ndim else None
    evicted = torch.zeros((), dtype=torch.int32, device=rows.device)
    for lo in range(0, rows.shape[0], UPSERT_SLICE_ROWS):
        r = rows[lo : lo + UPSERT_SLICE_ROWS]
        part = DiffStore(iters.index_select(0, r), vals.index_select(0, r), count.index_select(0, r))
        ones = torch.ones(r.shape, dtype=torch.bool, device=r.device)
        i_rows = i if i_flat is None else i_flat.index_select(0, r)
        out, evict, _ = upsert(part, i_rows, ones, new_flat.index_select(0, r))
        iters.index_copy_(0, r, out.iters)
        vals.index_copy_(0, r, out.vals)
        count.index_copy_(0, r, out.count)
        evicted += evict.sum(dtype=torch.int32)
    return evicted


def remove_at(store: DiffStore, i: Tensor | int, mask: Tensor) -> DiffStore:
    """Remove the change point at exactly iteration ``i`` where ``mask``.

    Used when maintenance finds that a previously-stored diff vanishes (the
    new value equals the preceding change point: the +/- pair cancels).
    """
    eq = store.iters == _col(i)
    do = mask & eq.any(dim=-1)
    pos = _first_true(eq)
    ar = torch.arange(store.capacity, device=store.iters.device)
    shift = do[..., None] & (ar >= pos[..., None])
    out_iters = torch.where(shift, _shift_left(store.iters, IMAX), store.iters)
    out_vals = torch.where(shift, _shift_left(store.vals, 0.0), store.vals)
    out_count = torch.where(do, store.count - 1, store.count)
    return DiffStore(out_iters, out_vals, out_count)


def gather_rows(store: DiffStore, idx: Tensor) -> DiffStore:
    """Reindex the key axis (second-to-last): result row ``k`` is input row
    ``idx[k]``; ``idx[k] < 0`` yields an empty row."""
    ok = idx >= 0
    safe = idx.clamp(min=0).long()
    iters = torch.where(ok[..., None], store.iters.index_select(-2, safe), IMAX)
    vals = torch.where(ok[..., None], store.vals.index_select(-2, safe), 0.0)
    count = torch.where(ok, store.count.index_select(-1, safe), 0)
    return DiffStore(iters, vals, count)


def nbytes_used(store: DiffStore, bytes_per_entry: int = 8) -> Tensor:
    """Accountant view: live entries × (4B iter + 4B state) — the paper's
    difference-count-based memory metering."""
    return store.count.sum() * bytes_per_entry
