"""SCRATCH baseline (§6.1.3): re-execute the static IFE after every batch.

Identical step function to the engine's JOD path — the same fixpoint loop
the original DD paper calls the static algorithm — but no difference sets are
kept (zero maintenance memory, maximal recompute cost).  It is the oracle the
engine's answers are checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (
    ITER_TRACE,
    EngineConfig,
    GraphArrays,
    MaintainStats,
    _stats_to_host,
    ife_step,
    resolve_device,
    zeros_stats,
)
from repro_torch.core.graph import DynamicGraph

Tensor = torch.Tensor


def scratch_run(
    cfg: EngineConfig, g: GraphArrays, init: Tensor
) -> tuple[Tensor, MaintainStats]:
    """Run IFE to fixpoint (or max_iters) from the initial states.

    Stats come back in the dense engine's :class:`MaintainStats` schema;
    fields SCRATCH has no analog for are zero.  ``scheduled`` is V × iters
    per query — every vertex reruns every iteration.
    """
    i, cur, changed = 1, init, True
    while i <= cfg.max_iters and changed:
        new = ife_step(cfg, cur, g)
        changed = bool((new != cur).any())
        cur, i = new, i + 1
    iters = i - 1
    q, v = init.shape
    per_iter = q * v
    # every iteration reruns the full matrix; iterations beyond the trace
    # depth fold into the last bin (as dense)
    sched = np.where(np.arange(ITER_TRACE) < min(iters, ITER_TRACE), per_iter, 0)
    sched[ITER_TRACE - 1] += max(iters - ITER_TRACE, 0) * per_iter
    dev = init.device
    stats = zeros_stats(dev)._replace(
        iters_run=torch.tensor(iters, dtype=torch.int32, device=dev),
        scheduled=torch.tensor(iters * per_iter, dtype=torch.int32, device=dev),
        sched_sizes=torch.tensor(sched, dtype=torch.int32, device=dev),
    )
    return cur, stats


class Scratch:
    """From-scratch continuous query processor (the paper's SCRATCH)."""

    def __init__(self, cfg: EngineConfig, graph: DynamicGraph, init, *, device=None) -> None:
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)
        self.init = torch.as_tensor(init, dtype=torch.float32).to(self.device)
        self._rerun()

    def _rerun(self) -> None:
        self.g = GraphArrays.from_snapshot(
            self.graph.snapshot(), backend=self.cfg.backend, device=self.device
        )
        self._answers, stats = scratch_run(self.cfg, self.g, self.init)
        self.last_stats = _stats_to_host(stats)

    def apply_updates(self, updates) -> MaintainStats:
        self.graph.apply_batch(updates)
        self._rerun()
        return self.last_stats

    def answers(self) -> np.ndarray:
        return self._answers.cpu().numpy()

    def nbytes(self) -> int:
        return 0  # no differences maintained


def scratch_like(
    engine_cfg: EngineConfig, graph: DynamicGraph, init, *, device=None
) -> Scratch:
    """Scratch twin of a Diff-IFE engine (same semiring/query batch)."""
    return Scratch(engine_cfg, graph, init, device=device)
