"""Carry engine state across from the reference and back, as numpy leaves.

The reference's ``EngineState``/``GraphArrays``/``UpdateBatch`` pulled to
numpy become a flat ``{name: ndarray}`` dict (store leaves as
``"dstore/iters"``, ``"dstore/vals"``, ``"dstore/count"``; DroppedVT scalars
as ``"drop/det_overflow"``, ``"drop/max_iter"``; the Det store as
``"drop_det/{iters,vals,count}"``; the Bloom filter as ``"drop_flt/bits"``
and ``"drop_flt/num_hashes"``; the selection rows as
``"drop_params/{p,tau_min,tau_max,degree_sel,seed}"`` with the seed in
uint32; the VDC J store as ``"jstore/{iters,vals,count}"`` and its per-slot
flags as ``"join_mat"``; the rest by field name).  These functions turn such a dict into the
port's tensors on a device (the seed held in int64), and the port's state
back into the same dict, so a run can move between the two packages
mid-stream and be compared leaf by leaf.

:func:`transformer_params_from_reference` does the same for a model's
parameter tree (or its decode cache): nested dicts, lists, tuples and named
tuples of numpy leaves, the reference's nesting kept, each leaf's dtype
kept — every transformer family's tree (GQA, MLA, MoE), MIND's flat float32
dict and the GNNs' trees (dicts and lists of float32 leaves).
:func:`adamw_state_from_reference` carries an optimizer state across.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.core.engine import EngineState, GraphArrays, UpdateBatch, resolve_device

_STATE_TENSORS = ("init", "cur", "repair_counts", "active")


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _store(leaves: dict[str, np.ndarray], prefix: str, device) -> ds.DiffStore:
    return ds.DiffStore(*(_t(leaves[f"{prefix}/{k}"], device) for k in ("iters", "vals", "count")))


def _drop_state_from_numpy(leaves: dict[str, np.ndarray], device) -> dr.DropState:
    det = flt = params = None
    if "drop_det/iters" in leaves:
        det = _store(leaves, "drop_det", device)
    if "drop_flt/bits" in leaves:
        flt = bloom.BloomFilter(_t(leaves["drop_flt/bits"], device), int(leaves["drop_flt/num_hashes"]))
    if "drop_params/p" in leaves:
        params = dr.DropParams(*(
            _t(np.asarray(leaves[f"drop_params/{f}"]).astype(np.int64) if f == "seed"
               else leaves[f"drop_params/{f}"], device)
            for f in dr.DropParams._fields
        ))
    return dr.DropState(
        det=det,
        flt=flt,
        det_overflow=_t(leaves["drop/det_overflow"], device),
        max_iter=_t(leaves["drop/max_iter"], device),
        params=params,
    )


def engine_state_from_numpy(leaves: dict[str, np.ndarray], device) -> EngineState:
    """The port's :class:`EngineState` from the reference's numpy leaves
    (the J store and ``join_mat`` where the state is VDC's)."""
    return EngineState(
        dstore=_store(leaves, "dstore", device),
        jstore=_store(leaves, "jstore", device) if "jstore/iters" in leaves else None,
        drop=_drop_state_from_numpy(leaves, device),
        join_mat=_t(leaves["join_mat"], device) if "join_mat" in leaves else None,
        **{k: _t(leaves[k], device) for k in _STATE_TENSORS},
    )


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """The inverse of :func:`engine_state_from_numpy`."""
    out = {f"dstore/{k}": getattr(state.dstore, k).cpu().numpy() for k in ("iters", "vals", "count")}
    if state.jstore is not None:
        out.update({f"jstore/{k}": getattr(state.jstore, k).cpu().numpy() for k in ("iters", "vals", "count")})
        out["join_mat"] = state.join_mat.cpu().numpy()
    drop = state.drop
    out["drop/det_overflow"] = drop.det_overflow.cpu().numpy()
    out["drop/max_iter"] = drop.max_iter.cpu().numpy()
    if drop.det is not None:
        out.update({f"drop_det/{k}": getattr(drop.det, k).cpu().numpy() for k in ("iters", "vals", "count")})
    if drop.flt is not None:
        out["drop_flt/bits"] = drop.flt.bits.cpu().numpy()
        out["drop_flt/num_hashes"] = np.asarray(drop.flt.num_hashes)
    if drop.params is not None:
        for f in dr.DropParams._fields:
            x = getattr(drop.params, f).cpu().numpy()
            out[f"drop_params/{f}"] = x.astype(np.uint32) if f == "seed" else x
    for k in _STATE_TENSORS:
        out[k] = getattr(state, k).cpu().numpy()
    return out


def graph_arrays_from_numpy(leaves: dict[str, np.ndarray], device) -> GraphArrays:
    """The port's :class:`GraphArrays` from numpy leaves named by field
    (``nbr``/``ell_w`` absent or None for the COO view)."""
    return GraphArrays(
        **{
            f: None if leaves.get(f) is None else _t(leaves[f], device)
            for f in GraphArrays._fields
        }
    )


def graph_arrays_to_numpy(g: GraphArrays) -> dict[str, np.ndarray]:
    return {f: getattr(g, f).cpu().numpy() for f in GraphArrays._fields if getattr(g, f) is not None}


def update_batch_from_numpy(leaves: dict[str, np.ndarray], device) -> UpdateBatch:
    """The port's :class:`UpdateBatch` from numpy leaves named by field."""
    return UpdateBatch(**{f: _t(leaves[f], device) for f in UpdateBatch._fields})


def _leaf_from_numpy(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16: carried as its bits, so the values stay exact
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return _t(x, device)


def transformer_params_from_reference(tree, device=None):
    """The reference's transformer parameters (or decode cache) pulled to
    numpy — dicts and tuples of arrays, layers stacked ``[L, ...]`` — as
    the port's tensors on ``device`` (default: the CUDA device), with the
    same nesting and dtypes."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: transformer_params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a named tuple takes its fields positionally
        return type(tree)(*(transformer_params_from_reference(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(transformer_params_from_reference(v, device) for v in tree)
    return _leaf_from_numpy(tree, device)


def adamw_state_from_reference(state, device=None):
    """The reference's ``AdamWState(step, mu, nu)`` pulled to numpy as the
    port's :class:`~repro_torch.optim.adamw.AdamWState` (``step`` an int32
    scalar tensor) on ``device``."""
    from repro_torch.optim.adamw import AdamWState

    device = resolve_device(device)
    return AdamWState(step=_leaf_from_numpy(np.asarray(state.step, np.int32), device),
                      mu=transformer_params_from_reference(state.mu, device),
                      nu=transformer_params_from_reference(state.nu, device))
