"""Fault-tolerant step supervisor: checkpoint/restart + failure injection.

The port of ``repro/runtime/fault.py``.  ``Supervisor.run`` drives a step
function under a restart policy: on a failure (any ``RuntimeError`` — in
PyTorch a CUDA error or ``torch.OutOfMemoryError`` is one — or an injected
``InjectedFault``) it restores the latest checkpoint, rebuilds program
state through ``on_restart``, and resumes.  Deterministic data order is
preserved by keying the input pipeline on the step counter, so a restart
replays the exact failed step.  ``history`` names every fault's type, so a
caller can tell an injected drill from a real device error that the
restart papered over.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.fault")


class InjectedFault(RuntimeError):
    """Simulated device/host failure for tests and drills."""


@dataclasses.dataclass
class FaultPolicy:
    max_restarts: int = 5
    checkpoint_every: int = 50
    backoff_s: float = 0.0  # delay before restart (0 in tests)


@dataclasses.dataclass
class StepResult:
    state: object
    metrics: dict


class Supervisor:
    """Wraps a step loop with checkpoint/restart fault handling."""

    def __init__(
        self,
        ckpt: CheckpointManager,
        policy: FaultPolicy | None = None,
        *,
        fault_injector: Callable[[int], None] | None = None,
        on_restart: Callable[[object, int], object] | None = None,
    ) -> None:
        self.ckpt = ckpt
        # a `FaultPolicy()` default argument would be one shared mutable
        # instance across every Supervisor; build a fresh one per instance
        self.policy = policy if policy is not None else FaultPolicy()
        self.fault_injector = fault_injector
        self.on_restart = on_restart
        self.restarts = 0
        self.history: list[str] = []

    def run(
        self,
        state,
        step_fn: Callable[[object, int], StepResult],
        *,
        start_step: int = 0,
        num_steps: int,
    ):
        """Run ``num_steps`` steps with checkpointing and restart-on-fault."""
        step = start_step
        while step < start_step + num_steps:
            try:
                if self.fault_injector is not None:
                    self.fault_injector(step)
                res = step_fn(state, step)
                state = res.state
                if (step + 1) % self.policy.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state)
                    self.history.append(f"ckpt@{step + 1}")
                step += 1
            except (InjectedFault, RuntimeError) as e:  # CUDA errors are RuntimeErrors
                self.restarts += 1
                self.history.append(f"fault@{step}:{type(e).__name__}")
                log.warning("step %d failed (%s); restart %d", step, e, self.restarts)
                if self.restarts > self.policy.max_restarts:
                    raise
                if self.policy.backoff_s:
                    time.sleep(self.policy.backoff_s)
                try:
                    state, restored_step = self.ckpt.restore_latest(state)
                    step = restored_step
                except FileNotFoundError:
                    step = start_step  # no checkpoint yet → restart from scratch
                if self.on_restart is not None:
                    state = self.on_restart(state, step)
                self.history.append(f"resume@{step}")
        self.ckpt.wait()
        return state, step
