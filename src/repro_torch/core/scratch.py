"""SCRATCH baseline (§6.1.3): re-execute the static IFE after every batch.

Identical step function to the engine's JOD path — the same fixpoint loop
the original DD paper calls the static algorithm — but no difference sets are
kept (zero maintenance memory, maximal recompute cost).  It is the oracle the
engine's answers are checked against.

:class:`ScratchEngine` is the session-protocol form (`core/session.py`):
queries register and deregister as :class:`~repro_torch.core.plan.QueryPlan`
rows of a host-side init matrix, and every update batch re-runs the static
IFE for the whole matrix.  :class:`Scratch` is the fixed-batch wrapper.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import plan as qp
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


class ScratchEngine:
    """From-scratch CQP with a runtime query lifecycle (session protocol).

    Registered plans occupy rows of a host-side init matrix; re-execution
    covers all rows in one run.  ``nbytes`` is 0 by construction: no
    differences are ever maintained.
    """

    def __init__(self, cfg: EngineConfig, graph: DynamicGraph, *, device=None) -> None:
        self.cfg = cfg  # num_queries tracks the slot count
        self.graph = graph
        self.device = resolve_device(device)
        self.plans: dict[int, qp.QueryPlan] = {}
        self._rows: dict[int, np.ndarray] = {}
        self._free: list[int] = []
        self._num_slots = 0
        self.g = self._device_graph()
        self._answers = np.zeros((0, cfg.num_vertices), np.float32)
        self.last_stats: MaintainStats | None = None

    def _device_graph(self) -> GraphArrays:
        return GraphArrays.from_snapshot(
            self.graph.snapshot(), backend=self.cfg.backend, device=self.device
        )

    # ---------------------------------------------------------------- slots
    def register_plan(self, plan: qp.QueryPlan) -> int:
        return self.register_plans([plan])[0]

    def register_plans(self, plans: list[qp.QueryPlan]) -> list[int]:
        """Claim all slots first, then re-execute once."""
        slots = []
        for plan in plans:
            slot = self._free.pop() if self._free else self._num_slots
            self._num_slots = max(self._num_slots, slot + 1)
            self.plans[slot] = plan
            self._rows[slot] = plan.build_init(self.cfg.num_vertices)
            slots.append(slot)
        self._rerun()
        return slots

    def deregister_plan(self, slot: int) -> int:
        if slot not in self.plans:
            raise ValueError(f"slot {slot} is not registered")
        del self.plans[slot], self._rows[slot]
        self._free.append(slot)
        self._free.sort(reverse=True)
        # answers() stays slot-aligned with the other engines: a freed slot
        # reads as the identity row, without re-running the computation
        if slot < self._answers.shape[0]:
            self._answers[slot] = self.cfg.semiring.identity
        if not self.plans:
            self._answers = np.zeros((0, self.cfg.num_vertices), np.float32)
        return 0  # SCRATCH holds no differences

    def active_slots(self) -> list[int]:
        return sorted(self.plans)

    # ----------------------------------------------------- governor surface
    def nbytes_per_query(self) -> dict[int, int]:
        return {s: 0 for s in sorted(self.plans)}

    def nbytes_per_operator(self) -> dict[int, dict[str, int]]:
        return {s: {"iterate": 0} for s in sorted(self.plans)}

    def recompute_cost_per_query(self) -> dict[int, int]:
        """Every slot pays the full re-execution: the scheduled count is
        shared evenly, so the governor's signals stay comparable."""
        n = max(len(self.plans), 1)
        total = 0 if self.last_stats is None else int(self.last_stats.scheduled)
        return {s: total // n for s in sorted(self.plans)}

    def recompute_cost_per_operator(self) -> dict[int, dict[str, int]]:
        return {s: {"iterate": c} for s, c in self.recompute_cost_per_query().items()}

    def set_drop_params(self, slot: int, cfg, op_id: str = "iterate") -> int:
        """SCRATCH is already the zero-memory end of the ladder."""
        if slot not in self.plans:
            raise ValueError(f"slot {slot} is not registered")
        return 0

    # ------------------------------------------------------------ execution
    def _init_matrix(self) -> np.ndarray:
        """[num_slots, V]; retired slots re-run as identity rows."""
        init = np.full((self._num_slots, self.cfg.num_vertices), self.cfg.semiring.identity, np.float32)
        for slot, row in self._rows.items():
            init[slot] = row
        return init

    def _rerun(self) -> None:
        if not self.plans:
            self._answers = np.zeros((0, self.cfg.num_vertices), np.float32)
            return
        cfg = dataclasses.replace(self.cfg, num_queries=self._num_slots)
        init = torch.from_numpy(self._init_matrix()).to(self.device)
        ans, stats = scratch_run(cfg, self.g, init)
        self.last_stats = _stats_to_host(stats)
        self._answers = ans.cpu().numpy().copy()  # writable: deregister blanks rows

    def apply_updates(self, updates):
        self.graph.apply_batch(updates)
        self.g = self._device_graph()
        self._rerun()
        return self.last_stats

    def apply_updates_batched(self, updates, batch_size: int | None = None):
        del batch_size
        return self.apply_updates(list(updates))

    # ------------------------------------------------------------------ api
    def answers_row(self, slot: int) -> np.ndarray:
        if slot not in self.plans:
            raise ValueError(f"slot {slot} is not registered")
        return self._answers[slot].copy()

    def answers(self) -> np.ndarray:
        return self._answers.copy()

    def nbytes(self) -> int:
        return 0  # no differences maintained

    # ------------------------------------------------------------ durability
    def export_state(self) -> tuple[dict[str, np.ndarray], dict]:
        """SCRATCH holds no differences: the checkpoint is the plan rows
        plus the work counters the governor reads (the reference's meta).
        Answers are re-derived from the restored graph at import."""
        ls = self.last_stats
        meta = {
            "num_slots": int(self._num_slots),
            "free_slots": [int(s) for s in self._free],
            "plans": {str(s): p.to_json() for s, p in self.plans.items()},
            "last_iters": None if ls is None else int(ls.iters_run),
            "last_scheduled": None if ls is None else int(ls.scheduled),
        }
        return {}, meta

    def import_state(self, arrays: dict, meta: dict) -> None:
        """Load an :meth:`export_state` snapshot (of either package): the
        plans rebuild their init rows, the computation reruns on the
        restored graph, and ``last_stats`` carries the saved counters."""
        del arrays
        self.plans = {int(s): qp.QueryPlan.from_json(p) for s, p in meta["plans"].items()}
        self._num_slots = int(meta["num_slots"])
        self._free = [int(s) for s in meta["free_slots"]]
        self._rows = {s: p.build_init(self.cfg.num_vertices) for s, p in self.plans.items()}
        self._rerun()
        if meta["last_iters"] is not None:
            # the pre-crash run's counters, not the import rerun's, so the
            # governor's recompute signal continues where it left off
            self.last_stats = _stats_to_host(zeros_stats())._replace(
                iters_run=np.int32(meta["last_iters"]),
                scheduled=np.int32(meta["last_scheduled"]),
            )
