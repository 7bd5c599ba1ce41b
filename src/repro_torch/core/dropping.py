"""Partial difference dropping (paper §5): configuration and the disabled path.

The port so far runs with dropping disabled (``DropConfig.mode == "none"``):
this module carries the configuration the plan IR and the engine read, the
per-query selection rows, and the empty DroppedVT state.  The Det-Drop store
and the Prob-Drop Bloom filter come with the dropping slice of the port; a
config that enables either raises :class:`NotImplementedError` here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Accounted bytes of one query's DropParams row: p (f32) + tau_min (f32) +
# tau_max (f32) + degree_sel (1 B) + seed (u32).
PARAMS_ROW_NBYTES = 17

UNPORTED = (
    "drop.mode={mode!r} (Det-/Prob-Drop) is not ported yet: it comes with the "
    "dropping slice of the port (ROADMAP Queue 1 item 3(c)); use mode='none'"
)


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
        seed=torch.tensor(seed, dtype=torch.int64, device=device) & 0xFFFFFFFF,
    )


class DropState(NamedTuple):
    """DroppedVT — tracks dropped (vertex, iteration) pairs."""

    det: object | None  # Det-Drop store (dropping slice)
    flt: object | None  # Prob-Drop Bloom filter (dropping slice)
    det_overflow: Tensor  # int32 — det evictions that lost a dropped VT
    max_iter: Tensor  # int32 — highest iteration ever dropped
    params: DropParams | None = None  # per-query selection ([Q] rows)


def make_state(
    cfg: DropConfig,
    num_queries: int,
    num_keys: int,
    per_query: "list[DropConfig] | None" = None,
    device=None,
) -> DropState:
    """DroppedVT state for ``num_queries`` slots (disabled mode only)."""
    del num_queries, num_keys, per_query
    if cfg.mode not in ("none", "det", "prob"):
        raise ValueError(f"unknown drop mode {cfg.mode!r}")
    if cfg.enabled():
        raise NotImplementedError(UNPORTED.format(mode=cfg.mode))
    return DropState(
        det=None,
        flt=None,
        det_overflow=torch.zeros((), dtype=torch.int32, device=device),
        max_iter=torch.full((), -1, dtype=torch.int32, device=device),
    )
