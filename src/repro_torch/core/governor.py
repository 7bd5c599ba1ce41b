"""Memory governor — budget-driven adaptive dropping (closed-loop §5).

The port of ``repro/core/governor.py`` (pure Python, unchanged but for the
package it imports).  Its ``landmark`` rung acts on the plan optimizer's
shared index (``repro_torch.planner.landmark_rewrite``).

The paper shows *what* to drop (Det/Bloom DroppedVT, Random/Degree
selection) and measures the memory/recompute trade-off per hand-tuned
policy.  This module operates it: DBSP and Graphsurge both make the system,
not the user, decide what incremental state to materialize, and a CQP
serving a churning query population needs the same — a global byte budget
enforced online by retuning each query's drop policy.

**Operator granularity.**  Enforcement is addressed at ``(query, operator)``
— the plan IR (`core/dataflow.py`) gives every query a dataflow of operators
each owning its own difference store, and the governor walks *operators*
along per-operator ladders:

* ``iterate`` — the §5 selection ladder:

      0   its own registered policy (usually no dropping)
      1…  escalating selection pressure — ``p`` rises along
          ``GovernorConfig.ladder_p`` and, under Degree selection, τ_min
          tightens by ``tau_tighten`` per rung
      top drop-all (p = 1): the dense engine keeps only ≤4 B DroppedVT
          records / Bloom bits and repairs on access; the host engine
          interprets drop-all as its **scratch fallback** — the query's
          difference index is dropped entirely and its answers are
          re-executed from scratch per batch (zero diff bytes, maximal
          recompute — the paper's SCRATCH endpoint, per query).

* ``join`` — a single rung: the operator's differences drop *completely*
  (§4's JOD, per slot): rung 1 zeroes the query's J-store rows and its
  messages recompute on demand; stepping back down re-materializes the
  trace with one re-derivation sweep.  This is the paper's
  operator-dropping scenario — "drop the Join's differences, keep the
  Iterate's" — and needs no DroppedVT bookkeeping, because complete
  dropping repairs deterministically.

* ``landmark`` — the plan optimizer's shared-index pseudo-operator (keyed
  ``(PLANNER_QID, "landmark")`` by the plan optimizer), another single rung:
  rung 1 sheds the landmark index (its 2·L maintained SSSP rows deregister
  and the rewritten queries degrade to un-pruned scratch — answers stay
  exact, latency rises), rung 0 re-materializes it.  "Landmark-ize /
  de-landmark-ize" is thereby an online memory↔latency knob alongside
  dropping (DESIGN.md §16).

Escalation rewrites the operator's policy in place — traced ``[Q]`` rows,
no engine recompile — and sheds already-stored diffs under the new policy
(``engine.shed_slot`` / ``engine.set_join_store``), so memory falls
immediately, not just for future writes.

**Victim choice.**  Over budget, the governor escalates the ``(query,
operator)`` with the most reclaimable bytes per unit of recent recompute
cost (``bytes / (1 + cost_rate)`` from :class:`RecomputeTelemetry`) — i.e.
it spends recomputation where it is cheapest.  For an RPQ with a
materialized join that is typically the join trace first (large, cheap to
re-derive), the iterate's change points only under further pressure.
Operators whose escalation coincides with Det-Drop overflow growth are
skipped (records lost to eviction cannot be repaired, so pushing them
harder risks staleness).

**Hysteresis.**  Under ``low_water × budget`` for ``cooldown_passes``
consecutive passes, the most escalated operator steps DOWN one rung (diffs
regrow naturally as sweeps write points), so a transient spike does not
pin the population at drop-all forever, and the escalate/de-escalate bands
never overlap.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import dropping as dr
from repro_torch.core.telemetry import RecomputeTelemetry
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Budget-enforcement knobs (the budget itself is ``CQPSession``'s
    ``budget_bytes``)."""

    representation: str = "det"  # auto-provisioned DroppedVT repr: det | prob
    ladder_p: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)  # rungs 1..top
    selection: str = "random"  # random | degree
    tau_tighten: float = 4.0  # degree selection: τ_min += k·tau_tighten
    low_water: float = 0.7  # de-escalate below low_water × budget
    cooldown_passes: int = 2  # consecutive calm passes before de-escalating
    max_actions_per_pass: int = 16
    det_capacity: int = 32  # provisioned representation capacities
    bloom_bits: int = 1 << 10
    seed: int = 0

    def __post_init__(self):
        if self.representation not in ("det", "prob"):
            raise ValueError(f"unknown representation {self.representation!r}")
        if self.selection not in ("random", "degree"):
            # fail at construction, not on the first over-budget pass
            raise ValueError(f"unknown selection {self.selection!r}")
        if not self.ladder_p or list(self.ladder_p) != sorted(self.ladder_p):
            raise ValueError("ladder_p must be a nondecreasing, nonempty tuple")
        if not (0.0 < self.low_water < 1.0):
            raise ValueError("low_water must be in (0, 1)")

    @property
    def top_level(self) -> int:
        return len(self.ladder_p)

    def representation_config(self) -> dr.DropConfig:
        """The p=0 DroppedVT provisioning a governor session installs when no
        registered plan brings one: shapes are allocated, nothing drops until
        the governor escalates."""
        return dr.DropConfig(
            mode=self.representation,
            selection=self.selection,
            p=0.0,
            det_capacity=self.det_capacity,
            bloom_bits=self.bloom_bits,
            seed=self.seed,
        )

    def rung_config(self, level: int, base: dr.DropConfig) -> dr.DropConfig:
        """The Iterate operator's DropConfig at ladder ``level``.

        Level 0 restores ``base`` (the query's registered policy).  Higher
        rungs keep the query's seed when it already had one — the stateless
        coin then makes successive rungs' drop sets nested, so escalation
        monotonically sheds and de-escalation never thrashes the store.
        """
        if level <= 0:
            return base
        p = self.ladder_p[min(level, self.top_level) - 1]
        degree_sel = self.selection == "degree"
        return dr.DropConfig(
            mode=self.representation,
            selection=self.selection,
            p=float(p),
            tau_min=(2.0 + self.tau_tighten * level) if degree_sel else 2.0,
            det_capacity=self.det_capacity,
            bloom_bits=self.bloom_bits,
            seed=base.seed if base.enabled() else self.seed,
        )

    def join_rung(self, level: int, base: dr.DropConfig | None) -> dr.DropConfig:
        """The Join operator's single-rung ladder: level 0 restores the
        registered policy (materialize, unless the plan registered the join
        dropped), level ≥ 1 drops the trace completely (recompute-on-demand
        — no partial rungs and no DroppedVT footprint, §4)."""
        if level <= 0:
            return base if base is not None else dr.DropConfig()
        return dr.DropConfig(mode=self.representation, selection="random", p=1.0)

    def top_level_for(self, op: str) -> int:
        # single-rung operators: the join trace (complete dropping, §4) and
        # the planner's shared landmark index (shed / re-materialize)
        return 1 if op in ("join", "landmark") else self.top_level


@dataclasses.dataclass
class GovernorAction:
    """One retuning decision, attributed at (query, operator) granularity,
    for the serving log / JSON report."""

    seq: int  # session.updates_applied when the action fired
    qid: int
    kind: str  # "escalate" | "deescalate"
    level_from: int
    level_to: int
    bytes_freed: int
    nbytes_after: int
    reason: str
    op: str = "iterate"  # the operator whose store the action retuned

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class MemoryGovernor:
    """Budget-enforcement loop over one :class:`~repro_torch.core.session.CQPSession`.

    The session calls :meth:`enforce` after every ingest / register /
    deregister; the governor meters per-query bytes through the engine
    protocol, folds recompute signals into :class:`RecomputeTelemetry`, and
    walks queries along the policy ladder until the byte budget holds.
    """

    def __init__(
        self,
        budget_bytes: int,
        cfg: GovernorConfig | None = None,
        telemetry: RecomputeTelemetry | None = None,
    ) -> None:
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        self.budget_bytes = int(budget_bytes)
        self.cfg = cfg or GovernorConfig()
        self.telemetry = telemetry or RecomputeTelemetry()
        # ladder rung per (qid, op_id) — the governor's (query, operator)
        # address space; ``levels`` exposes the legacy per-query iterate view
        self._levels: dict[tuple[int, str], int] = {}
        self.actions: list[GovernorAction] = []
        # (qid, op_id) → registered policy (level-0 restore point)
        self._base: dict[tuple[int, str], dr.DropConfig | None] = {}
        # det-overflow escalation guard: overflow growth is attributed to the
        # most recently escalated operator (sheds and the drops its new
        # policy causes are the prime suspects), which is then barred from
        # further escalation until it de-escalates — never a global lockout
        self._overflow_blocked: set[tuple[int, str]] = set()
        self._last_escalated: tuple[int, str] | None = None
        self._overflow_mark = 0
        # bytes each operator's escalations reclaimed (net of observed
        # regrowth) — the de-escalation guard's regrowth estimate
        self._reclaimed: dict[tuple[int, str], int] = {}
        self._calm_passes = 0
        self.passes = 0

    @property
    def levels(self) -> dict[int, int]:
        """Legacy per-query view: each query's Iterate-operator rung."""
        return {
            qid: lvl for (qid, op), lvl in self._levels.items() if op == "iterate"
        }

    @property
    def op_levels(self) -> dict[tuple[int, str], int]:
        return dict(self._levels)

    # ------------------------------------------------------------ lifecycle
    def on_register(self, qid: int, plan) -> None:
        """Track a registered plan's droppable operators (its graph nodes;
        engine-implicit operators surface lazily through the byte meters)."""
        self._levels[(qid, "iterate")] = 0
        self._base[(qid, "iterate")] = plan.drop
        if "join" in plan.droppable_ops():
            self._levels[(qid, "join")] = 0
            self._base[(qid, "join")] = plan.join_drop

    def on_deregister(self, qid: int) -> None:
        for key in [k for k in self._levels if k[0] == qid]:
            self._levels.pop(key, None)
            self._base.pop(key, None)
            self._overflow_blocked.discard(key)
            self._reclaimed.pop(key, None)
            if self._last_escalated == key:
                self._last_escalated = None

    # ---------------------------------------------------------- enforcement
    def enforce(self, session) -> list[GovernorAction]:
        """One budget-enforcement pass over the (query, operator) table;
        returns the actions taken."""
        per_op = session._nbytes_per_op_map()
        self.telemetry.observe(
            nbytes_per_query=per_op,
            cost_per_query=session._recompute_cost_op_map(),
            stats=session.last_stats,
            updates_applied=session.updates_applied,
        )
        new_actions: list[GovernorAction] = []
        total = sum(per_op.values())
        self._check_overflow(session)
        while total > self.budget_bytes and len(new_actions) < self.cfg.max_actions_per_pass:
            cands = [
                key
                for key in per_op
                if self._levels.get(key, 0) < self.cfg.top_level_for(key[1])
                and key not in self._overflow_blocked
                # an empty store has nothing to reclaim — escalating it only
                # burns a rung (the iterate rung still thins future writes,
                # but a join flip or an index shed would be a pure no-op)
                and not (key[1] in ("join", "landmark") and per_op[key] == 0)
            ]
            if not cands:
                break
            key = max(
                cands,
                key=lambda k: per_op[k] / (1.0 + self.telemetry.cost_rate(k)),
            )
            # a shed's delta is exactly the global delta (it touches one
            # slot's accounted rows), so the loop never re-meters the engine
            action = self._step(session, key, +1, "over budget", total)
            new_actions.append(action)
            per_op[key] = max(per_op[key] - action.bytes_freed, 0)
            total = action.nbytes_after
            self._check_overflow(session)
        if new_actions:
            self._calm_passes = 0
        elif total <= self.cfg.low_water * self.budget_bytes:
            self._calm_passes += 1
            # predictive guard: only relieve an operator whose reclaimed
            # bytes would still fit under the low-water mark if they all
            # came back — de-escalating at the floor just to re-escalate
            # next pass (host: a full index rebuild each way) is the flap
            # hysteresis exists to prevent
            headroom_for = self.cfg.low_water * self.budget_bytes - total
            escalated = [
                key
                for key in per_op
                if self._levels.get(key, 0) > 0
                and self._reclaimed.get(key, 0) <= headroom_for
            ]
            if escalated and self._calm_passes > self.cfg.cooldown_passes:
                # relieve the operator paying the most recompute per update
                key = max(escalated, key=self.telemetry.cost_rate)
                new_actions.append(
                    self._step(session, key, -1, "headroom recovered", total)
                )
                self._calm_passes = 0
        else:
            self._calm_passes = 0
        self.actions.extend(new_actions)
        self.passes += 1
        return new_actions

    def _check_overflow(self, session) -> None:
        """Attribute DroppedVT record loss (sweep evictions + shed evictions)
        to the most recently escalated operator and bar it from further
        escalation — lost records cannot be repaired, so pushing the same
        store harder risks stale answers.  De-escalation lifts the bar."""
        overflow = self.telemetry.det_overflow_total + session._det_overflow_shed()
        if overflow > self._overflow_mark and self._last_escalated is not None:
            self._overflow_blocked.add(self._last_escalated)
            self._last_escalated = None
        self._overflow_mark = overflow

    def _step(
        self, session, key: tuple[int, str], direction: int, reason: str, total: int
    ) -> GovernorAction:
        qid, op = key
        lvl = self._levels.get(key, 0)
        new_lvl = max(lvl + direction, 0)
        base = self._base.get(key, dr.DropConfig() if op != "join" else None)
        if op in ("join", "landmark"):
            # both are single-rung complete-drop ladders: rung 1 sheds the
            # store (join trace / shared landmark index), rung 0 restores it
            cfg_new = self.cfg.join_rung(new_lvl, base)
        else:
            cfg_new = self.cfg.rung_config(new_lvl, base)
        with obs_trace.span(
            "escalate" if direction > 0 else "deescalate",
            "governor",
            pid="governor",
            tid=qid,
            qid=qid,
            op=op,
            level_from=lvl,
            level_to=new_lvl,
            reason=reason,
        ) as sp:
            freed = session._set_op_drop_policy_qid(qid, op, cfg_new)
            sp.set(bytes_freed=int(freed))
        if direction > 0:
            self._last_escalated = key
            self._reclaimed[key] = self._reclaimed.get(key, 0) + max(int(freed), 0)
            after = total - int(freed)
        else:
            # de-escalation may regrow state (host scratch-fallback exit and
            # join re-materialization rebuild stores), so re-meter this one
            self._overflow_blocked.discard(key)
            after = session.nbytes()
            regrow = max(after - total, 0)
            self._reclaimed[key] = (
                0 if new_lvl == 0 else max(self._reclaimed.get(key, 0) - regrow, 0)
            )
        self._levels[key] = new_lvl
        return GovernorAction(
            seq=session.updates_applied,
            qid=qid,
            kind="escalate" if direction > 0 else "deescalate",
            level_from=lvl,
            level_to=new_lvl,
            bytes_freed=int(freed),
            nbytes_after=after,
            reason=reason,
            op=op,
        )

    # ------------------------------------------------------------ durability
    def state_dict(self) -> dict:
        """JSON-able full state: ladder rungs, restore-point policies,
        overflow guard, hysteresis counters, action log, telemetry EWMAs."""

        def cfg_dict(cfg: dr.DropConfig | None) -> dict | None:
            return None if cfg is None else dataclasses.asdict(cfg)

        return {
            "budget_bytes": self.budget_bytes,
            "cfg": dataclasses.asdict(self.cfg),
            "levels": [
                {"qid": q, "op": op, "level": lvl}
                for (q, op), lvl in self._levels.items()
            ],
            "base": [
                {"qid": q, "op": op, "cfg": cfg_dict(cfg)}
                for (q, op), cfg in self._base.items()
            ],
            "overflow_blocked": [list(k) for k in self._overflow_blocked],
            "last_escalated": (
                None if self._last_escalated is None else list(self._last_escalated)
            ),
            "overflow_mark": self._overflow_mark,
            "reclaimed": [
                {"qid": q, "op": op, "bytes": b}
                for (q, op), b in self._reclaimed.items()
            ],
            "calm_passes": self._calm_passes,
            "passes": self.passes,
            "actions": [a.to_dict() for a in self.actions],
            "telemetry": self.telemetry.state_dict(),
        }

    def load_state(self, state: dict) -> None:
        self.budget_bytes = int(state["budget_bytes"])
        cfg = dict(state["cfg"])
        cfg["ladder_p"] = tuple(cfg["ladder_p"])
        self.cfg = GovernorConfig(**cfg)
        self._levels = {
            (int(e["qid"]), e["op"]): int(e["level"]) for e in state["levels"]
        }
        self._base = {
            (int(e["qid"]), e["op"]): (
                None if e["cfg"] is None else dr.DropConfig(**e["cfg"])
            )
            for e in state["base"]
        }
        self._overflow_blocked = {
            (int(q), op) for q, op in state["overflow_blocked"]
        }
        self._last_escalated = (
            None
            if state["last_escalated"] is None
            else (int(state["last_escalated"][0]), state["last_escalated"][1])
        )
        self._overflow_mark = int(state["overflow_mark"])
        self._reclaimed = {
            (int(e["qid"]), e["op"]): int(e["bytes"]) for e in state["reclaimed"]
        }
        self._calm_passes = int(state["calm_passes"])
        self.passes = int(state["passes"])
        self.actions = [GovernorAction(**a) for a in state["actions"]]
        self.telemetry.load_state(state["telemetry"])

    # ------------------------------------------------------------------ api
    def headroom(self, session) -> int:
        return self.budget_bytes - session.nbytes()

    def headroom_fraction(self, session) -> float:
        """Headroom as a fraction of the budget (≤ 0 when over budget) —
        the admission controller's governor-pressure signal."""
        return self.headroom(session) / self.budget_bytes

    def snapshot(self, session=None) -> dict:
        out = {
            "budget_bytes": self.budget_bytes,
            "passes": self.passes,
            "escalations": sum(1 for a in self.actions if a.kind == "escalate"),
            "deescalations": sum(
                1 for a in self.actions if a.kind == "deescalate"
            ),
            "levels": {str(q): lvl for q, lvl in sorted(self.levels.items())},
            "op_levels": {
                f"{q}/{op}": lvl
                for (q, op), lvl in sorted(self._levels.items())
            },
            "overflow_blocked": sorted({q for (q, _op) in self._overflow_blocked}),
            "actions": [a.to_dict() for a in self.actions],
            "telemetry": self.telemetry.snapshot(),
        }
        if session is not None:
            out["headroom_bytes"] = self.headroom(session)
            out["det_overflow_shed"] = session._det_overflow_shed()
        return out
