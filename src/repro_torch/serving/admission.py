"""SLO-based admission control with a graceful-degradation ladder.

The port of ``repro/serving/admission.py``.

The serving loop feeds the controller one observation per epoch (per-chunk
maintenance wall time, governor byte headroom, ingest backlog); the
controller keeps a sliding p99 window plus EWMAs of both signals and
classifies the tier as calm or overloaded.  Requests are then **admitted**,
**queued**, or **rejected**:

* update submissions — admitted into the ingest queue, or rejected when the
  tier is shedding (rate-quota rejections are the tenant's own contract and
  can fire any time);
* query registrations — admitted at the next epoch boundary, queued while
  the tier is overloaded (re-evaluated every epoch), rejected while
  shedding.

**Degrade before rejecting.**  An overloaded epoch first escalates the
lowest-priority tenant one rung down the drop-policy ladder
(:meth:`TenantRegistry.degrade` — sheds stored diffs, answers stay exact
via repair-on-access).  Only when *every* tenant sits at the top rung does
the controller enter shedding mode and start rejecting work — so the
action log always shows the full degradation ladder before the first
overload rejection.  Calm epochs past the cooldown undo degradations one
rung at a time (LIFO); shedding ends only once the overload stays clear
through the cooldown (hysteresis — an instant clear would re-admit a burst
that immediately re-overloads and the oscillation inflates read tails).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.serving.tenants import TenantRegistry


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Admission thresholds.

    ``p99_target_ms`` is the maintenance-latency SLO (None disables the
    latency trigger); ``backlog_high_updates`` is the ingest-queue
    high-water mark; ``min_headroom_frac`` the governor-headroom floor
    (0 disables it — the right value when the session runs no byte
    budget)."""

    p99_target_ms: float | None = None
    backlog_high_updates: int = 64
    min_headroom_frac: float = 0.0
    latency_window: int = 64
    ewma_alpha: float = 0.2
    cooldown_epochs: int = 2

    def __post_init__(self):
        if self.p99_target_ms is not None and self.p99_target_ms <= 0:
            raise ValueError("p99_target_ms must be positive (or None)")
        if not (0.0 <= self.min_headroom_frac < 1.0):
            raise ValueError("min_headroom_frac must be in [0, 1)")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str  # "admit" | "queue" | "reject"
    reason: str

    @property
    def admitted(self) -> bool:
        return self.action == "admit"


ADMIT = Decision("admit", "ok")


class AdmissionRejected(Exception):
    """A submission or registration the controller refused.

    Deliberately NOT a ``RuntimeError`` — the serving loop treats
    ``RuntimeError`` as a recoverable engine fault, and a policy rejection
    must never trigger checkpoint restore."""

    def __init__(self, decision: Decision) -> None:
        super().__init__(f"{decision.action}: {decision.reason}")
        self.decision = decision


class AdmissionController:
    """One admission state machine per serving loop."""

    def __init__(self, cfg: SLOConfig, registry: TenantRegistry) -> None:
        self.cfg = cfg
        self.registry = registry
        self._window: deque[float] = deque(maxlen=cfg.latency_window)
        self.latency_ewma_s: float | None = None
        self.headroom_ewma: float | None = None
        self.backlog = 0
        self.shedding = False
        self._calm_epochs = 0
        self.epochs = 0
        self.rejected_updates = 0
        self.rejected_registers = 0
        self.straggler_sheds = 0

    # ------------------------------------------------------------- signals
    def observe_epoch(
        self,
        maintain_s: float,
        *,
        headroom_frac: float | None = None,
        backlog_updates: int = 0,
    ) -> None:
        """Fold one epoch's signals in (called by the loop after every
        applied chunk, before :meth:`regulate`)."""
        a = self.cfg.ewma_alpha
        self._window.append(float(maintain_s))
        self.latency_ewma_s = (
            maintain_s
            if self.latency_ewma_s is None
            else (1 - a) * self.latency_ewma_s + a * maintain_s
        )
        if headroom_frac is not None:
            self.headroom_ewma = (
                headroom_frac
                if self.headroom_ewma is None
                else (1 - a) * self.headroom_ewma + a * headroom_frac
            )
        self.backlog = int(backlog_updates)
        self.epochs += 1

    def p99_ms(self) -> float:
        if not self._window:
            return 0.0
        return float(np.percentile(np.asarray(self._window), 99.0) * 1e3)

    def overloaded(self) -> bool:
        lat = (
            self.cfg.p99_target_ms is not None
            and self.p99_ms() > self.cfg.p99_target_ms
        )
        backlog = self.backlog > self.cfg.backlog_high_updates
        headroom = (
            self.cfg.min_headroom_frac > 0.0
            and self.headroom_ewma is not None
            and self.headroom_ewma < self.cfg.min_headroom_frac
        )
        return lat or backlog or headroom

    # ------------------------------------------------------------ decisions
    def admit_updates(
        self, tenant_id: str, n: int, *, backlog_updates: int | None = None
    ) -> Decision:
        """Admission for one update submission of ``n`` updates.

        ``backlog_updates`` is the live ingest-queue depth at submission
        time.  When the ladder is already fully degraded and the live
        backlog breaches the high-water mark, shedding re-engages
        immediately — between epoch boundaries — so a recovery probe after
        a calm spell admits at most one high-water mark's worth of work
        before the gate closes again (an unbounded probe burst would
        inflate the admitted tenants' read tails)."""
        st = self.registry.require(tenant_id)
        st.submitted_updates += n
        if not self.registry.allow_rate(tenant_id, n):
            st.rejected_updates += n
            self.rejected_updates += n
            return Decision("reject", "rate quota")
        if (
            not self.shedding
            and backlog_updates is not None
            and backlog_updates > self.cfg.backlog_high_updates
            and self.registry.fully_degraded()
        ):
            self.shedding = True
            self._calm_epochs = 0
        if self.shedding:
            st.rejected_updates += n
            self.rejected_updates += n
            return Decision("reject", "overload shed")
        st.admitted_updates += n
        return ADMIT

    def admit_register(self, tenant_id: str) -> Decision:
        """Admission for one query registration."""
        st = self.registry.require(tenant_id)
        if self.shedding:
            st.rejected_registers += 1
            self.rejected_registers += 1
            return Decision("reject", "overload shed")
        if self.overloaded():
            return Decision("queue", "overloaded")
        return ADMIT

    # --------------------------------------------------------------- ladder
    def regulate(self, session) -> list[dict]:
        """One per-epoch control pass: degrade under overload (one rung per
        epoch), shed only past the ladder, restore when calm."""
        actions: list[dict] = []
        if self.overloaded():
            self._calm_epochs = 0
            target = self.registry.next_degradable()
            if target is not None:
                action = self.registry.degrade(
                    session, target.spec.tenant_id, "admission overload"
                )
                if action is not None:
                    actions.append(action)
            else:
                # ladder exhausted: now — and only now — reject new work
                self.shedding = True
        else:
            self._calm_epochs += 1
            # hysteresis: shedding persists through the cooldown — the
            # drained backlog must HOLD calm before new work is re-admitted.
            # Clearing the moment one epoch looks calm re-admits a burst
            # that immediately re-overloads, and the resulting backlog
            # oscillation inflates the admitted tenants' read tails.
            if self._calm_epochs > self.cfg.cooldown_epochs:
                self.shedding = False
                action = self.registry.restore_one(session, "calm")
                if action is not None:
                    actions.append(action)
                    self._calm_epochs = 0
        return actions

    def force_shed(self, session, reason: str) -> dict | None:
        """An out-of-band escalation (the straggler detector's hook): one
        ladder step immediately, shedding if the ladder is exhausted."""
        self.straggler_sheds += 1
        target = self.registry.next_degradable()
        if target is None:
            self.shedding = True
            return None
        return self.registry.degrade(session, target.spec.tenant_id, reason)

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        return {
            "epochs": self.epochs,
            "p99_ms": self.p99_ms(),
            "latency_ewma_ms": (
                None
                if self.latency_ewma_s is None
                else self.latency_ewma_s * 1e3
            ),
            "headroom_ewma": self.headroom_ewma,
            "backlog": self.backlog,
            "shedding": self.shedding,
            "calm_epochs": self._calm_epochs,
            "rejected_updates": self.rejected_updates,
            "rejected_registers": self.rejected_registers,
            "straggler_sheds": self.straggler_sheds,
            "p99_target_ms": self.cfg.p99_target_ms,
        }

    def state_dict(self) -> dict:
        return {
            "window": list(self._window),
            "latency_ewma_s": self.latency_ewma_s,
            "headroom_ewma": self.headroom_ewma,
            "shedding": self.shedding,
            "calm_epochs": self._calm_epochs,
            "epochs": self.epochs,
            "rejected_updates": self.rejected_updates,
            "rejected_registers": self.rejected_registers,
            "straggler_sheds": self.straggler_sheds,
        }

    def load_state(self, state: dict) -> None:
        self._window = deque(
            (float(x) for x in state["window"]), maxlen=self.cfg.latency_window
        )
        self.latency_ewma_s = state["latency_ewma_s"]
        self.headroom_ewma = state["headroom_ewma"]
        self.shedding = bool(state["shedding"])
        self._calm_epochs = int(state["calm_epochs"])
        self.epochs = int(state["epochs"])
        self.rejected_updates = int(state["rejected_updates"])
        self.rejected_registers = int(state["rejected_registers"])
        self.straggler_sheds = int(state["straggler_sheds"])
