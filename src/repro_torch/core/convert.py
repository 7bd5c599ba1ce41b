"""Carry engine state across from the reference and back, as numpy leaves.

The reference's ``EngineState``/``GraphArrays``/``UpdateBatch`` pulled to
numpy become a flat ``{name: ndarray}`` dict (store leaves as
``"dstore/iters"``, ``"dstore/vals"``, ``"dstore/count"``; DroppedVT scalars
as ``"drop/det_overflow"``, ``"drop/max_iter"``; the rest by field name).
These functions turn such a dict into the port's tensors on a device, and
the port's state back into the same dict, so a run can move between the two
packages mid-stream and be compared leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.core.engine import EngineState, GraphArrays, UpdateBatch

_STATE_TENSORS = ("init", "cur", "repair_counts", "active")


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def engine_state_from_numpy(leaves: dict[str, np.ndarray], device) -> EngineState:
    """The port's :class:`EngineState` from the reference's numpy leaves
    (JOD, dropping disabled: no J store, no DroppedVT rows)."""
    for name in ("jstore/iters", "drop_det/iters", "drop_flt/bits", "join_mat"):
        if name in leaves:
            raise NotImplementedError(f"leaf {name!r} belongs to an unported configuration")
    return EngineState(
        dstore=ds.DiffStore(*(_t(leaves[f"dstore/{k}"], device) for k in ("iters", "vals", "count"))),
        jstore=None,
        drop=dr.DropState(
            det=None,
            flt=None,
            det_overflow=_t(leaves["drop/det_overflow"], device),
            max_iter=_t(leaves["drop/max_iter"], device),
        ),
        **{k: _t(leaves[k], device) for k in _STATE_TENSORS},
    )


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """The inverse of :func:`engine_state_from_numpy`."""
    out = {f"dstore/{k}": getattr(state.dstore, k).cpu().numpy() for k in ("iters", "vals", "count")}
    out["drop/det_overflow"] = state.drop.det_overflow.cpu().numpy()
    out["drop/max_iter"] = state.drop.max_iter.cpu().numpy()
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
