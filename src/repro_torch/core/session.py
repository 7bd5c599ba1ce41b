"""Session layer of the port.  So far only :func:`engine_config_for`, the one
place a plan family becomes an :class:`EngineConfig`; ``CQPSession`` comes
with the session slice of the port (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from repro_torch.core import dropping as dr
from repro_torch.core import plan as qp
from repro_torch.core.engine import EngineConfig


def engine_config_for(
    first_plan: qp.QueryPlan,
    *,
    num_queries: int,
    num_vertices: int,
    mode: str = "jod",
    drop: dr.DropConfig | None = None,
    store_capacity: int = 16,
    jstore_capacity: int = 8,
    backend: str = "coo",
) -> EngineConfig:
    """The :class:`EngineConfig` of a plan family.

    ``backend`` picks the sweep: ``"coo"`` (scatter-reduce), ``"ell"`` (the
    CUDA bucketed-ELL SpMV as aggregator, JOD only) or ``"fused"`` (the CUDA
    maintenance kernel, one launch per iteration).  ``drop`` passes through
    unchanged."""
    return EngineConfig(
        num_queries=num_queries,
        num_vertices=num_vertices,
        max_iters=int(first_plan.max_iters),
        semiring=first_plan.semiring,
        mode=mode,
        store_capacity=store_capacity,
        jstore_capacity=jstore_capacity,
        drop=drop or dr.DropConfig(),
        weight_from_degree=first_plan.weight_from_degree,
        alpha=first_plan.alpha,
        backend=backend,
    )
