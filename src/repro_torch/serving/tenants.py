"""Per-tenant registries: query tickets, byte budgets, and rate quotas.

The port of ``repro/serving/tenants.py`` (pure Python over the session's
public meters and ``set_drop_policy``).

A serving tier multiplexes many *tenants* over one :class:`CQPSession`.
Each tenant owns a set of registered queries (addressed by stable
:class:`QueryTicket` ids that survive fault recovery, unlike engine slots
or session qids), an optional **isolated byte budget** (its queries'
accounted difference bytes, enforced through the session's existing
``set_drop_policy`` / ``nbytes_per_query`` hooks — a per-tenant
mini-governor walking the same :class:`GovernorConfig` ladder the global
memory governor uses), a **rate quota** (token-bucket admitted updates/sec),
and a **priority** that orders the admission controller's degradation
ladder (low priority degrades first, restores last).

Degradation is tenant-granular: one rung moves *all* of the tenant's
queries one step along ``ladder.rung_config`` — escalation sheds stored
diffs in place (answers stay exact via repair-on-access, DESIGN.md §10),
so memory pressure falls immediately without deregistering anyone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.core import dropping as dr
from repro_torch.core.governor import GovernorConfig


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract."""

    tenant_id: str
    priority: int = 1  # higher = more important; degraded last, shed last
    budget_bytes: int | None = None  # isolated accounted-byte budget
    rate_per_s: float | None = None  # sustained admitted updates/sec
    burst: int = 64  # token-bucket capacity (updates)

    def __post_init__(self):
        if self.budget_bytes is not None and self.budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive (or None)")
        if self.rate_per_s is not None and self.rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive (or None)")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")


@dataclasses.dataclass(frozen=True)
class QueryTicket:
    """Stable handle for one tenant query — survives fault recovery (the
    session-level qid behind it may change when a crashed loop rebuilds
    from genesis; the ticket does not)."""

    ticket_id: int
    tenant_id: str


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec, ``burst`` capacity."""

    def __init__(self, rate: float, burst: int) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last: float | None = None

    def take(self, n: int, now: float) -> bool:
        if self._last is not None:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate
            )
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def state_dict(self) -> dict:
        return {"tokens": self.tokens}

    def load_state(self, state: dict) -> None:
        self.tokens = float(state["tokens"])
        self._last = None


@dataclasses.dataclass
class TenantState:
    """Mutable per-tenant serving state."""

    spec: TenantSpec
    bucket: TokenBucket | None
    level: int = 0  # degradation rung (0 = registered policies)
    watermark: int = 0  # admitted-stream seq the tenant's writes reach
    # ticket_id → session qid (rebuilt after recovery)
    qids: dict[int, int] = dataclasses.field(default_factory=dict)
    # ticket_id → the query's registered (level-0) drop policy
    base: dict[int, dr.DropConfig] = dataclasses.field(default_factory=dict)
    submitted_updates: int = 0
    admitted_updates: int = 0
    rejected_updates: int = 0
    rejected_registers: int = 0
    nbytes: int = 0  # last metered accounted bytes


class TenantRegistry:
    """The serving tier's tenant table.

    Owns tenancy state only — the *decisions* (admit/queue/reject) live in
    :class:`repro_torch.serving.admission.AdmissionController`; the registry
    provides the levers (degrade/restore one tenant one rung, enforce a
    tenant's own byte budget) and the meters (per-tenant bytes, quotas).
    """

    def __init__(
        self,
        ladder: GovernorConfig | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.ladder = ladder or GovernorConfig(representation="prob")
        self.clock = clock
        self._tenants: dict[str, TenantState] = {}
        self._next_ticket = 0
        self.actions: list[dict] = []  # degrade/restore/budget log
        # degradations in order, for last-in-first-out restore
        self._degrade_stack: list[str] = []

    # ------------------------------------------------------------ tenancy
    def add(self, spec: TenantSpec) -> TenantState:
        if spec.tenant_id in self._tenants:
            raise ValueError(f"tenant {spec.tenant_id!r} already registered")
        bucket = (
            None
            if spec.rate_per_s is None
            else TokenBucket(spec.rate_per_s, spec.burst)
        )
        st = TenantState(spec=spec, bucket=bucket)
        self._tenants[spec.tenant_id] = st
        return st

    def remove(self, tenant_id: str) -> list[int]:
        """Drop a tenant; returns the session qids its tickets held."""
        st = self.require(tenant_id)
        del self._tenants[tenant_id]
        self._degrade_stack = [t for t in self._degrade_stack if t != tenant_id]
        return list(st.qids.values())

    def require(self, tenant_id: str) -> TenantState:
        if tenant_id not in self._tenants:
            raise ValueError(f"unknown tenant {tenant_id!r}")
        return self._tenants[tenant_id]

    def tenants(self) -> list[TenantState]:
        return [self._tenants[t] for t in sorted(self._tenants)]

    def by_priority(self) -> list[TenantState]:
        """Ascending priority (degrade-first order), tenant_id tiebreak."""
        return sorted(
            self._tenants.values(), key=lambda s: (s.spec.priority, s.spec.tenant_id)
        )

    # ------------------------------------------------------------ tickets
    def new_ticket(self, tenant_id: str) -> QueryTicket:
        self.require(tenant_id)
        t = QueryTicket(ticket_id=self._next_ticket, tenant_id=tenant_id)
        self._next_ticket += 1
        return t

    def attach(
        self, ticket: QueryTicket, qid: int, base_drop: dr.DropConfig
    ) -> None:
        st = self.require(ticket.tenant_id)
        st.qids[ticket.ticket_id] = int(qid)
        st.base[ticket.ticket_id] = base_drop

    def detach(self, ticket: QueryTicket) -> int:
        st = self.require(ticket.tenant_id)
        st.base.pop(ticket.ticket_id, None)
        return st.qids.pop(ticket.ticket_id)

    def qid_of(self, ticket: QueryTicket) -> int:
        st = self.require(ticket.tenant_id)
        if ticket.ticket_id not in st.qids:
            raise ValueError(f"ticket {ticket.ticket_id} is not registered")
        return st.qids[ticket.ticket_id]

    def remap_qids(self, mapping: dict[int, int]) -> None:
        """Rewrite ticket → qid after a genesis rebuild reassigned qids."""
        for st in self._tenants.values():
            st.qids = {t: mapping.get(q, q) for t, q in st.qids.items()}

    def all_qids(self) -> dict[int, str]:
        """qid → tenant_id over every live ticket."""
        return {
            q: tid
            for tid, st in self._tenants.items()
            for q in st.qids.values()
        }

    # ------------------------------------------------------------- quotas
    def allow_rate(self, tenant_id: str, n: int) -> bool:
        """Spend ``n`` updates from the tenant's token bucket (always
        allowed for tenants with no rate quota)."""
        st = self.require(tenant_id)
        if st.bucket is None:
            return True
        return st.bucket.take(n, self.clock())

    # ------------------------------------------------------------- meters
    def bytes_by_tenant(self, session) -> dict[str, int]:
        """Per-tenant accounted difference bytes, via the session's public
        per-query meter (``nbytes_per_query`` aligned with ``handles``)."""
        per_qid = {
            h.qid: b
            for h, b in zip(session.handles(), session.nbytes_per_query())
        }
        out: dict[str, int] = {}
        for tid, st in self._tenants.items():
            st.nbytes = sum(per_qid.get(q, 0) for q in st.qids.values())
            out[tid] = st.nbytes
        return out

    # ------------------------------------------------- degradation ladder
    def _handles_by_qid(self, session) -> dict[int, object]:
        return {h.qid: h for h in session.handles()}

    def _apply_level(self, session, st: TenantState, level: int) -> int:
        """Rewrite every query of ``st`` to the ladder rung ``level``;
        returns the accounted bytes released (negative = regrown)."""
        handles = self._handles_by_qid(session)
        freed = 0
        for ticket_id, qid in st.qids.items():
            base = st.base.get(ticket_id, dr.DropConfig())
            cfg = self.ladder.rung_config(level, base)
            freed += session.set_drop_policy(handles[qid], cfg)
        return freed

    def degrade(self, session, tenant_id: str, reason: str) -> dict | None:
        """Escalate one tenant one rung down the drop ladder (sheds stored
        diffs in place); returns the action record, or None at the top."""
        st = self.require(tenant_id)
        if st.level >= self.ladder.top_level or not st.qids:
            return None
        freed = self._apply_level(session, st, st.level + 1)
        action = {
            "kind": "degrade",
            "tenant": tenant_id,
            "level_from": st.level,
            "level_to": st.level + 1,
            "bytes_freed": int(freed),
            "reason": reason,
        }
        st.level += 1
        self._degrade_stack.append(tenant_id)
        self.actions.append(action)
        return action

    def restore_one(self, session, reason: str) -> dict | None:
        """Undo the most recent degradation one rung (LIFO, so the
        lowest-priority tenants — degraded first — are restored last)."""
        while self._degrade_stack:
            tid = self._degrade_stack.pop()
            st = self._tenants.get(tid)
            if st is not None and st.level > 0:
                freed = self._apply_level(session, st, st.level - 1)
                action = {
                    "kind": "restore",
                    "tenant": tid,
                    "level_from": st.level,
                    "level_to": st.level - 1,
                    "bytes_freed": int(freed),
                    "reason": reason,
                }
                st.level -= 1
                self.actions.append(action)
                return action
        return None

    def next_degradable(self) -> TenantState | None:
        """The lowest-priority tenant with ladder headroom left."""
        for st in self.by_priority():
            if st.level < self.ladder.top_level and st.qids:
                return st
        return None

    def fully_degraded(self) -> bool:
        return self.next_degradable() is None

    def enforce_budgets(self, session) -> list[dict]:
        """Per-tenant budget enforcement: while a tenant's accounted bytes
        exceed *its own* budget and it has rungs left, walk it down the
        ladder.  Isolation: only the over-budget tenant's queries are
        rewritten — a co-tenant blowing its budget never degrades yours."""
        actions: list[dict] = []
        for tid, nbytes in sorted(self.bytes_by_tenant(session).items()):
            st = self._tenants[tid]
            if st.spec.budget_bytes is None:
                continue
            while (
                st.nbytes > st.spec.budget_bytes
                and st.level < self.ladder.top_level
                and st.qids
            ):
                action = self.degrade(session, tid, "tenant budget")
                if action is None:
                    break
                actions.append(action)
                st.nbytes = max(st.nbytes - max(action["bytes_freed"], 0), 0)
        return actions

    # --------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """JSON-able registry state for the checkpoint manifest's ``extra``
        block — a cross-process restore rebuilds tenancy from this."""

        def spec_dict(spec: TenantSpec) -> dict:
            return dataclasses.asdict(spec)

        return {
            "next_ticket": self._next_ticket,
            "degrade_stack": list(self._degrade_stack),
            "tenants": [
                {
                    "spec": spec_dict(st.spec),
                    "level": st.level,
                    "watermark": st.watermark,
                    "qids": {str(t): q for t, q in st.qids.items()},
                    "base": {
                        str(t): dataclasses.asdict(b)
                        for t, b in st.base.items()
                    },
                    "bucket": (
                        None if st.bucket is None else st.bucket.state_dict()
                    ),
                    "counters": {
                        "submitted_updates": st.submitted_updates,
                        "admitted_updates": st.admitted_updates,
                        "rejected_updates": st.rejected_updates,
                        "rejected_registers": st.rejected_registers,
                    },
                }
                for st in self.tenants()
            ],
        }

    def load_state(self, state: dict) -> None:
        self._next_ticket = int(state["next_ticket"])
        self._degrade_stack = list(state["degrade_stack"])
        self._tenants = {}
        for entry in state["tenants"]:
            spec = TenantSpec(**entry["spec"])
            st = self.add(spec)
            st.level = int(entry["level"])
            st.watermark = int(entry["watermark"])
            st.qids = {int(t): int(q) for t, q in entry["qids"].items()}
            st.base = {
                int(t): dr.DropConfig(**b) for t, b in entry["base"].items()
            }
            if st.bucket is not None and entry["bucket"] is not None:
                st.bucket.load_state(entry["bucket"])
            for k, v in entry["counters"].items():
                setattr(st, k, int(v))

    def snapshot(self) -> dict:
        """Per-tenant counters for ``server.stats()`` / JSON reports."""
        return {
            tid: {
                "priority": st.spec.priority,
                "budget_bytes": st.spec.budget_bytes,
                "rate_per_s": st.spec.rate_per_s,
                "level": st.level,
                "queries": len(st.qids),
                "nbytes": st.nbytes,
                "watermark": st.watermark,
                "submitted_updates": st.submitted_updates,
                "admitted_updates": st.admitted_updates,
                "rejected_updates": st.rejected_updates,
                "rejected_registers": st.rejected_registers,
            }
            for tid, st in sorted(self._tenants.items())
        }
