"""AccessDᵢᵛWithDrops — the paper's §5.1 access procedure, faithful form.

The port of ``repro/core/access.py``.  The engine's maintenance sweep
repairs dropped diffs inline (forward form, see engine.py); this module is
the paper's *standalone* access path — "give me D_i^v right now" against a
store with dropped change points — for read-only consumers (answer
extraction mid-epoch, debugging, tests) and as the executable specification
the dense sweep is checked against.  It is host numpy over the port's
tensors, one vertex at a time.

Steps (paper §5.1.1 / §5.1.2):
  1. g* ← latest stored change point ≤ i for v.
  2. d* ← latest dropped VT pair ≤ i for v (Det: sorted store lookup;
     Prob: Bloom probes downward from i — false positives allowed).
  3. If d* > g*: recompute the value at d* by rerunning the aggregator at
     d*−1, whose in-neighbour reads recurse through this same procedure.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dropping as dr
from repro_torch.core.engine import EngineConfig, EngineState, GraphArrays
from repro_torch.core.semiring import reduce_pair


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def access(
    cfg: EngineConfig,
    state: EngineState,
    g: GraphArrays,
    v: int,
    i: int,
    *,
    _depth: int = 0,
) -> np.ndarray:
    """D_i^v per query — the recursive scalar procedure. Returns [Q]."""
    iters = state.dstore.iters[:, v].cpu().numpy()  # [Q, S]
    vals = state.dstore.vals[:, v].cpu().numpy()
    init = state.init[:, v].cpu().numpy()
    q = iters.shape[0]

    # step 1: latest stored ≤ i
    le = iters <= i
    g_star = np.where(le.any(axis=1), np.max(np.where(le, iters, -1), axis=1), -1)
    idx = np.clip(le.sum(axis=1) - 1, 0, None)
    stored_val = np.where(g_star >= 0, vals[np.arange(q), idx], init)

    if not cfg.drop.enabled() or _depth > cfg.max_iters:
        return stored_val

    # step 2: latest dropped ≤ i (per query) — probe downward like §5.1.2
    d_star = np.full(q, -1, np.int64)
    for j in range(i, -1, -1):
        probe = dr.dropped_at(state.drop, j, cfg.num_vertices)[:, v].cpu().numpy()
        d_star = np.where((d_star < 0) & probe & (j > g_star), j, d_star)
        if (d_star >= 0).all():
            break

    out = stored_val.copy()
    need = d_star > g_star
    if need.any():
        # step 3: recompute at d* from in-neighbour values at d*−1
        src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
        valid, w = g.valid.cpu().numpy(), g.weight.cpu().numpy()
        in_edges = np.nonzero(valid & (dst == v))[0]
        for qi in np.nonzero(need)[0]:
            di = int(d_star[qi])
            best = access(cfg, state, g, v, di - 1, _depth=_depth + 1)[qi]
            for e in in_edges:
                u = int(src[e])
                uval = access(cfg, state, g, u, di - 1, _depth=_depth + 1)[qi]
                cand = float(cfg.semiring.msg(_f32(uval), _f32(w[e])))
                best = float(reduce_pair(cfg.semiring, _f32(cand), _f32(best)))
            out[qi] = best
    return out
