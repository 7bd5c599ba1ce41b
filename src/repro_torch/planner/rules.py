"""Rewrite-rule framework: match → cost gate → rewrite → shared runtime.

The port of ``repro/planner/rules.py``.

A :class:`RewriteRule` is two things at once:

* a **pattern** over validated operator graphs: ``matches(plan, session)``
  inspects the plan's nodes (semiring, init, join/transform presence,
  aggregate shape) and the session family, and ``rewrite(plan, session)``
  produces a new *validated* plan with a :class:`~repro_torch.core.plan.Provenance`
  entry recorded — answers stay attributable to the rule that produced them;
* a **runtime** for the rewritten strategy: rules that share state across
  matching queries (the landmark pass shares one 2·L-field index) own that
  state per session and serve the lifecycle hooks below (`admit`/`release`/
  `on_updates`/`answers`), byte accounting (`extra_nbytes`/`pseudo_ops`) and
  the governor lever (`set_policy`).

The :class:`Planner` orchestrates: at registration it runs each candidate
plan through the rule list, gates the first match through the cost model
(:mod:`repro_torch.planner.cost` — ``optimize="always"`` bypasses the gate), and
routes the query's lifecycle to the owning rule from then on.  Rewritten
queries hold ordinary :class:`~repro_torch.core.session.QueryHandle`s; the session
delegates `answers`/`deregister`/byte accounting for them to the planner.

Governor interaction: rule-owned shared state surfaces in the session's
victim table as pseudo-operator rows keyed ``(PLANNER_QID, op)`` — the
ladder escalates them like any (query, operator) pair, and the resulting
``set_drop_params`` call routes back to ``Planner.set_pseudo_policy`` so
"shed the shared index / re-materialize it" is an online memory↔latency
rung alongside dropping.
"""

from __future__ import annotations

from repro_torch.core import plan as qp
from repro_torch.planner.cost import CostModel

# pseudo qid addressing rule-owned shared state in governor victim tables;
# real qids count up from 0, so the namespaces never collide
PLANNER_QID = -1
# the landmark pass's pseudo-operator id (its ladder rung lives in
# GovernorConfig alongside "join")
INDEX_OP = "landmark"

MODES = ("none", "auto", "always")


class RewriteRule:
    """Base rule: subclasses override the pattern and (if their strategy
    owns runtime state) the lifecycle hooks.  One rule instance serves one
    session — rules may keep per-session state on ``self``."""

    name = "rule"

    # ------------------------------------------------------------- pattern
    def matches(self, plan: qp.QueryPlan, session) -> bool:
        raise NotImplementedError

    def pays(self, plan: qp.QueryPlan, session, cost: CostModel):
        """Cost-gate decision: ``(pays: bool, estimate_dict)``."""
        return True, {}

    def rewrite(self, plan: qp.QueryPlan, session) -> qp.QueryPlan:
        """The transformation: a new validated plan with provenance."""
        raise NotImplementedError

    # ------------------------------------------------------------- runtime
    def admit(self, session, qid: int, plan: qp.QueryPlan) -> None:
        """Take ownership of a rewritten query (build shared state on the
        first admit)."""
        raise NotImplementedError

    def release(self, session, qid: int) -> int:
        """Drop ownership; returns bytes freed (shared state tears down
        with its last owner)."""
        raise NotImplementedError

    def on_updates(self, session, updates) -> None:
        """One δE batch was ingested (engine maintenance already ran)."""

    def answers(self, session, qid: int):
        raise KeyError(qid)

    # ------------------------------------------------------ byte accounting
    def extra_nbytes(self, session) -> int:
        """Bytes owned outside the session engine (e.g. a reverse-graph
        twin session) — folded into ``session.nbytes()``."""
        return 0

    def pseudo_ops(self, session) -> dict:
        """``(PLANNER_QID, op) → bytes`` rows for the governor victim table.
        Count only bytes NOT already metered under engine qids."""
        return {}

    def pseudo_costs(self, session) -> dict:
        """``(PLANNER_QID, op) → cumulative recompute-cost`` counters
        (telemetry EWMAs rank shed victims by bytes/(1+cost_rate))."""
        return {}

    def set_policy(self, session, cfg) -> int:
        """Governor rung for the rule's pseudo-operator: an enabled config
        sheds the shared state (returns bytes freed), a disabled one
        re-materializes it."""
        return 0

    # ---------------------------------------------------------- durability
    def snapshot(self, session) -> dict:
        return {}

    def state_dict(self, session) -> tuple[dict, dict]:
        """(arrays, meta) for the rule's shared state; array keys must be
        namespaced (``planner_<rule>/…``)."""
        return {}, {}

    def load_state(self, session, meta: dict, arrays: dict, owned: dict) -> None:
        """Rebuild shared state at restore; ``owned`` maps the rule's
        restored qids to their plans (engine state is already imported)."""


class Planner:
    """Per-session rewrite orchestrator (`CQPSession(optimize=...)`).

    ``mode``: ``"none"`` registers every plan untouched, ``"auto"`` applies
    a matching rule when its cost estimate pays, ``"always"`` applies every
    match unconditionally.  A per-call ``register(..., optimize=...)``
    overrides the session default.
    """

    def __init__(self, session, mode: str = "auto", *, rules=None, cost=None):
        if mode not in MODES:
            raise ValueError(f"unknown optimize mode {mode!r}; choose {MODES}")
        self.session = session
        self.mode = mode
        self.cost = cost if cost is not None else CostModel()
        if rules is None:
            from repro_torch.planner.landmark_rewrite import LandmarkRule

            rules = [LandmarkRule()]
        self.rules: list[RewriteRule] = list(rules)
        self.owned: dict[int, RewriteRule] = {}  # qid → owning rule
        self.decisions: list[dict] = []  # rewrite decision log (obs/report)
        self.rewrites_total = 0

    # ------------------------------------------------------------ admission
    def consider(self, plan: qp.QueryPlan, mode: str | None = None):
        """The rule that should own this plan, or None to register it
        untouched.  Logs cost-gate rejections."""
        mode = self.mode if mode is None else mode
        if mode == "none":
            return None
        for rule in self.rules:
            if not rule.matches(plan, self.session):
                continue
            if mode == "always":
                return rule
            pays, est = rule.pays(plan, self.session, self.cost)
            if pays:
                return rule
            self.decisions.append(
                {"rule": rule.name, "kind": plan.kind, "applied": False, **est}
            )
        return None

    def admit(self, qid: int, plan: qp.QueryPlan, rule: RewriteRule) -> qp.QueryPlan:
        """Rewrite ``plan`` under ``rule`` and hand it the query's runtime."""
        new_plan = rule.rewrite(plan, self.session)
        rule.admit(self.session, qid, new_plan)
        self.owned[qid] = rule
        self.rewrites_total += 1
        self.decisions.append(
            {"rule": rule.name, "kind": plan.kind, "applied": True, "qid": qid}
        )
        return new_plan

    def owns(self, qid: int) -> bool:
        return qid in self.owned

    def release(self, qid: int) -> int:
        return self.owned.pop(qid).release(self.session, qid)

    # -------------------------------------------------------------- runtime
    def on_updates(self, updates) -> None:
        for rule in self.rules:
            rule.on_updates(self.session, updates)

    def answers(self, qid: int):
        return self.owned[qid].answers(self.session, qid)

    def answers_snapshot(self) -> dict:
        # a rule's answers are an owned host copy already
        return {qid: rule.answers(self.session, qid) for qid, rule in self.owned.items()}

    # ------------------------------------------------------ byte accounting
    def extra_nbytes(self) -> int:
        return sum(r.extra_nbytes(self.session) for r in self.rules)

    def pseudo_ops(self) -> dict:
        out: dict = {}
        for rule in self.rules:
            out.update(rule.pseudo_ops(self.session))
        return out

    def pseudo_costs(self) -> dict:
        out: dict = {}
        for rule in self.rules:
            out.update(rule.pseudo_costs(self.session))
        return out

    def set_pseudo_policy(self, op: str, cfg) -> int:
        """Route a governor ``(PLANNER_QID, op)`` policy rewrite to the rule
        owning that pseudo-operator."""
        for rule in self.rules:
            if op == getattr(rule, "pseudo_op", None):
                return rule.set_policy(self.session, cfg)
        raise KeyError(f"no planner rule owns pseudo-operator {op!r}")

    # ----------------------------------------------------------- durability
    def snapshot(self) -> dict:
        out = {
            "mode": self.mode,
            "rewrites_total": self.rewrites_total,
            "managed_queries": sorted(self.owned),
            "decisions": list(self.decisions[-16:]),
        }
        for rule in self.rules:
            out[rule.name] = rule.snapshot(self.session)
        return out

    def state_dict(self) -> tuple[dict, dict]:
        arrays: dict = {}
        meta: dict = {
            "mode": self.mode,
            "rewrites_total": self.rewrites_total,
            "owned": {str(qid): rule.name for qid, rule in self.owned.items()},
            "rules": {},
        }
        for rule in self.rules:
            r_arrays, r_meta = rule.state_dict(self.session)
            arrays.update(r_arrays)
            meta["rules"][rule.name] = r_meta
        return arrays, meta

    def load_state(self, meta: dict, arrays: dict) -> None:
        self.mode = meta.get("mode", self.mode)
        self.rewrites_total = int(meta.get("rewrites_total", 0))
        by_name = {r.name: r for r in self.rules}
        self.owned = {}
        owned_by_rule: dict[str, dict] = {}
        for qid_s, rule_name in meta.get("owned", {}).items():
            qid = int(qid_s)
            rule = by_name[rule_name]
            self.owned[qid] = rule
            owned_by_rule.setdefault(rule_name, {})[qid] = self.session._plans[qid]
        for rule in self.rules:
            rule.load_state(
                self.session,
                meta.get("rules", {}).get(rule.name, {}),
                arrays,
                owned_by_rule.get(rule.name, {}),
            )
