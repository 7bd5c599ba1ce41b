"""The async multi-tenant CQP serving loop (DESIGN.md §14).

The port of ``repro/serving/server.py``.  One :class:`CQPServer` owns one
:class:`~repro_torch.core.session.CQPSession` (on the CUDA device unless the
session was built with ``device="cpu"``) and multiplexes many tenants over
it:

* **Single-writer ingest.**  Admitted δE updates land in an in-memory queue;
  an asyncio ingest loop drains them into fixed-size chunks and folds each
  through ``apply_updates_batched`` on an executor thread — the event loop
  (and every reader coroutine) stays responsive during the fold.  Sheds,
  epoch-view refreshes and headroom checks run on the loop thread, but
  never while a fold is in flight (each executor call is awaited before
  the next step), so two threads never drive the device at once.
* **Snapshot-consistent epoch reads.**  After every applied chunk the loop
  refreshes an *epoch view*: owned host copies of each query's answers
  (``session.answers_snapshot()``; the engine edits its device state in
  place).  Reads serve from the view, never the
  live engine, so a reader can never observe a half-applied chunk.
* **Read-your-writes freshness.**  Each admitted submission advances its
  tenant's watermark (admitted-stream sequence number).  ``read`` waits
  until the covered sequence reaches the watermark — or times out and
  serves the current epoch marked ``fresh=False``.  Under admission control
  the backlog is bounded, so reads are fast *and* fresh; the no-admission
  control run lets the backlog grow without bound and reads degrade into
  stale timeouts (the overload experiment in ``benchmarks/fig_serving_slo``).
* **Admission + tenancy.**  Per-epoch maintenance latency, governor
  headroom, and backlog feed :class:`AdmissionController`; per-tenant byte
  budgets are enforced by :meth:`TenantRegistry.enforce_budgets`.  A
  straggler event escalates the degradation ladder out-of-band (exactly
  once per event — the detector's policy hook is registered once).
* **Fault recovery.**  Engine faults inside a chunk apply restore the
  latest checkpoint through :class:`RecoverySupervisor` (or rebuild from
  genesis), replay the post-checkpoint control ops (register/deregister)
  and δE chunks from the in-memory logs, and resume — registered tenants
  and tickets survive; answers are bit-identical to an uninterrupted run.
  A fault is any ``RuntimeError`` (a CUDA error or
  ``torch.OutOfMemoryError`` is one), as in the reference: ``faults`` and
  the supervisor's ``history`` name each fault's type, so a caller can tell
  an injected drill from a real device error that recovery replayed over.

``python -m repro_torch.serving.server`` runs a deterministic scripted
scenario (register N tenants, stream updates, optionally inject one fault
mid-stream, restore, check every answer bit for bit against a scratch
oracle, deregister everyone) and prints a JSON report.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.core import dropping as dr
from repro_torch.core import plan as qp
from repro_torch.core.graph import DynamicGraph
from repro_torch.core.governor import GovernorConfig
from repro_torch.core.session import CQPSession
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import FaultPolicy, InjectedFault
from repro_torch.runtime.recovery import RecoverySupervisor
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.serving.admission import (
    ADMIT,
    AdmissionController,
    AdmissionRejected,
    Decision,
    SLOConfig,
)
from repro_torch.serving.metrics import PhaseRecorder, summarize_latency_s
from repro_torch.serving.tenants import QueryTicket, TenantRegistry, TenantSpec


# --------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving-loop knobs."""

    chunk_updates: int = 32  # ingest chunk size (and engine batch size)
    flush_interval_s: float = 0.0  # linger to let a partial chunk fill
    read_timeout_s: float = 2.0  # read-your-writes barrier timeout
    admission: bool = True  # False = control run (no admission/shedding)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    drop_ladder: GovernorConfig | None = None  # degradation ladder
    checkpoint_every: int = 0  # chunks between checkpoints (0 = never)
    checkpoint_keep: int = 3
    max_restarts: int = 5
    backoff_s: float = 0.0
    straggler_threshold: float = 4.0
    straggler_warmup: int = 3
    # observability: periodic scrape of the session into the obs metrics
    # registry every `obs_every` epochs, with optional file sinks — the
    # trace flush rewrites `trace_out` (Chrome-trace JSON) and the metrics
    # scrape rewrites `metrics_out` (registry JSON snapshot) in place, so
    # the files are valid mid-run and final on stop()
    obs_every: int = 8
    trace_out: str | None = None
    metrics_out: str | None = None

    def __post_init__(self):
        if self.chunk_updates < 1:
            raise ValueError("chunk_updates must be >= 1")
        if self.read_timeout_s <= 0:
            raise ValueError("read_timeout_s must be positive")
        if self.obs_every < 1:
            raise ValueError("obs_every must be >= 1")


@dataclasses.dataclass(frozen=True)
class SubmitResult:
    admitted: bool
    reason: str
    watermark: int  # the tenant's read-your-writes barrier after this submit


@dataclasses.dataclass(frozen=True)
class ReadResult:
    values: np.ndarray  # an owned epoch-view copy — never the live engine
    epoch: int
    covered: int  # admitted-stream prefix the view reflects
    required: int  # the tenant watermark this read targeted
    fresh: bool  # covered >= required (False = barrier timed out)
    wait_s: float


def build_serving_session(
    graph: DynamicGraph,
    *,
    ladder: GovernorConfig | None = None,
    engine: str = "dense",
    **kw,
) -> CQPSession:
    """A ``CQPSession`` provisioned for serving.

    Dense engines can only *enable* dropping on a query whose DroppedVT
    representation was provisioned at build time — so a serving session
    (whose admission ladder degrades queries mid-stream) must be built with
    the ladder's p=0 representation installed.  This helper mirrors what
    ``budget_bytes`` does for the global governor, without attaching one
    (the per-tenant mini-governors and the global governor would fight over
    the same DropParams rows).  ``kw`` passes through to
    :class:`CQPSession` (``device=None``: the CUDA device)."""
    ladder = ladder or GovernorConfig(representation="prob")
    if engine == "dense" and kw.get("drop") is None:
        kw["drop"] = ladder.representation_config()
    return CQPSession(graph, engine=engine, **kw)


# --------------------------------------------------------------------- server
class CQPServer:
    """Async serving front end over one ``CQPSession``.

    Not thread-safe: all public coroutines must run on the event loop that
    ``start`` was called from (the engine itself runs on an executor
    thread, but all bookkeeping is loop-confined)."""

    def __init__(
        self,
        session: CQPSession,
        *,
        config: ServerConfig | None = None,
        session_factory: Callable[[], CQPSession] | None = None,
        checkpoint_dir: str | None = None,
        mesh=None,
        fault_injector: Callable[[int], None] | None = None,
        delay_injector: Callable[[int], float] | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.config = config or ServerConfig()
        # the mesh a restore places the session's state onto
        self.mesh = mesh if mesh is not None else session.mesh
        self.session = session
        self.session_factory = session_factory
        self.clock = clock
        self.fault_injector = fault_injector
        self.delay_injector = delay_injector

        spec = getattr(session, "_drop_spec", None)
        self._can_degrade = (
            session.engine_kind != "dense"
            or (spec is not None and spec.enabled())
        )
        if self.config.admission and not self._can_degrade:
            raise ValueError(
                "admission control degrades queries mid-stream; build the "
                "dense session with a DroppedVT representation provisioned "
                "(repro_torch.serving.build_serving_session)"
            )
        ladder = self.config.drop_ladder or GovernorConfig(
            representation=(spec.mode if self._can_degrade and spec else "prob")
        )
        if (
            self._can_degrade
            and spec is not None
            and spec.enabled()
            and ladder.representation != spec.mode
        ):
            ladder = dataclasses.replace(ladder, representation=spec.mode)
        self.registry = TenantRegistry(ladder)
        self.admission = AdmissionController(self.config.slo, self.registry)
        self.metrics = PhaseRecorder()
        self.straggler = StragglerDetector(
            threshold=self.config.straggler_threshold,
            warmup=self.config.straggler_warmup,
        )
        # the detector fires every registered policy once per event; the
        # server registers exactly ONE — double-registration would walk the
        # ladder twice per straggler
        self.straggler.on_straggler(self._on_straggler)

        policy = FaultPolicy(
            max_restarts=self.config.max_restarts,
            checkpoint_every=self.config.checkpoint_every,
            backoff_s=self.config.backoff_s,
        )
        self.supervisor: RecoverySupervisor | None = None
        if checkpoint_dir is not None:
            self.supervisor = RecoverySupervisor(
                checkpoint_dir,
                policy,
                keep=self.config.checkpoint_keep,
                restore_fn=self._restore_fn,
                straggler=self.straggler,
            )
        else:
            self._policy = policy
            self._restarts = 0
        session.attach_runtime(
            straggler=self.straggler, supervisor=self.supervisor
        )

        # ingest state (loop-confined)
        self._queue: deque = deque()  # admitted updates not yet applied
        self._control: deque = deque()  # boundary ops: (kind, payload, future)
        self._chunk_log: list[list] = []  # applied chunks, in order
        self._control_log: list[dict] = []  # register/deregister replay log
        self._plans: dict[int, qp.QueryPlan] = {}  # ticket_id → plan
        self._pending_registers: deque = deque()  # queued (overload) registers
        self._admitted_total = 0  # admitted-stream sequence
        self._covered = 0  # applied prefix of the admitted stream
        self._epoch = 0
        self._view: dict[int, np.ndarray] = {}  # ticket_id → answers copy
        self._waiters: list[tuple[int, asyncio.Future]] = []
        self._wake: asyncio.Event | None = None
        self._idle: asyncio.Event | None = None
        self._stopping = False
        self._failure: BaseException | None = None
        self._task: asyncio.Task | None = None
        self.faults = 0
        self._read_wait: dict[str, list[float]] = {}
        self._read_lag: dict[str, list[int]] = {}
        self._stale_reads: dict[str, int] = {}

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("server already started")
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task = asyncio.create_task(self._ingest_loop(), name="cqp-ingest")

    async def stop(self) -> None:
        """Drain the queue, stop the loop, finish in-flight checkpoints."""
        if self._task is None:
            return
        self._stopping = True
        self._wake.set()
        try:
            await self._task
        finally:
            self._task = None
        if self.supervisor is not None:
            self.supervisor.manager.wait()
        self._obs_scrape()  # final flush: sinks reflect the drained state
        if self._failure is not None:
            raise self._failure

    async def drain(self) -> None:
        """Wait until every admitted update and control op is applied."""
        self._raise_if_failed()
        while self._queue or self._control or not self._idle.is_set():
            await self._idle.wait()
            self._raise_if_failed()

    async def __aenter__(self) -> "CQPServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        if exc[0] is None:
            await self.stop()
        else:  # don't mask the body's exception with a drain failure
            self._stopping = True
            if self._wake is not None:
                self._wake.set()
            if self._task is not None:
                await asyncio.gather(self._task, return_exceptions=True)
                self._task = None

    def _raise_if_failed(self) -> None:
        if self._failure is not None:
            raise self._failure

    # ---------------------------------------------------------------- tenancy
    def add_tenant(self, spec: TenantSpec):
        if spec.budget_bytes is not None:
            if getattr(self.session, "_governor", None) is not None:
                raise ValueError(
                    "tenant byte budgets and a session-global MemoryGovernor "
                    "both rewrite drop policies and would fight; use one or "
                    "the other (the governor can still feed the admission "
                    "headroom signal without tenant budgets)"
                )
            if not self._can_degrade:
                raise ValueError(
                    "tenant budget_bytes needs a DroppedVT representation "
                    "provisioned (repro_torch.serving.build_serving_session)"
                )
        return self.registry.add(spec)

    async def remove_tenant(self, tenant_id: str) -> None:
        """Deregister every live query of the tenant (at epoch boundaries —
        never while a chunk is folding in), then drop it."""
        st = self.registry.require(tenant_id)
        for ticket_id in list(st.qids):
            await self.deregister_query(QueryTicket(ticket_id, tenant_id))
        self.registry.remove(tenant_id)

    def _detach_ticket(self, ticket: QueryTicket) -> int:
        qid = self.registry.qid_of(ticket)
        handle = next(h for h in self.session.handles() if h.qid == qid)
        t0 = self.clock()
        freed = self.session.deregister(handle)
        self.metrics.record("deregister", self.clock() - t0)
        self.registry.detach(ticket)
        self._plans.pop(ticket.ticket_id, None)
        self._view.pop(ticket.ticket_id, None)
        self._control_log.append(
            {"cursor": len(self._chunk_log), "kind": "deregister",
             "ticket_id": ticket.ticket_id, "tenant_id": ticket.tenant_id,
             "qid": qid}
        )
        return freed

    # ----------------------------------------------------------- registration
    async def register_query(
        self, tenant_id: str, plan: qp.QueryPlan
    ) -> QueryTicket:
        """Admit (or queue, or reject) one query registration.

        Raises :class:`AdmissionRejected` when the tier is shedding.  A
        queued registration resolves at the first calm epoch boundary (or
        rejects if shedding starts first)."""
        self._raise_if_failed()
        self.registry.require(tenant_id)
        decision = (
            self.admission.admit_register(tenant_id)
            if self.config.admission
            else ADMIT
        )
        obs_trace.instant(
            "register_query",
            "admission",
            pid="serving",
            tid=tenant_id,
            tenant=tenant_id,
            action=decision.action,
            reason=decision.reason,
        )
        if decision.action == "reject":
            raise AdmissionRejected(decision)
        fut = asyncio.get_running_loop().create_future()
        if decision.action == "queue":
            self._pending_registers.append((tenant_id, plan, fut))
        else:
            self._control.append(("register", (tenant_id, plan), fut))
        self._wake.set()
        self._idle.clear()
        return await fut

    async def deregister_query(self, ticket: QueryTicket) -> int:
        """Retire a ticket's query at the next epoch boundary; returns the
        accounted bytes released."""
        self._raise_if_failed()
        self.registry.qid_of(ticket)  # validate now, not at the boundary
        fut = asyncio.get_running_loop().create_future()
        self._control.append(("deregister", ticket, fut))
        self._wake.set()
        self._idle.clear()
        return await fut

    # --------------------------------------------------------------- ingest
    def submit(self, tenant_id: str, updates) -> SubmitResult:
        """Submit δE updates for one tenant (synchronous — admission is a
        pure in-memory decision).  Admitted updates advance the tenant's
        read-your-writes watermark."""
        self._raise_if_failed()
        updates = list(updates)
        st = self.registry.require(tenant_id)
        if self.config.admission:
            decision = self.admission.admit_updates(
                tenant_id, len(updates), backlog_updates=len(self._queue)
            )
        else:
            st.submitted_updates += len(updates)
            st.admitted_updates += len(updates)
            decision = ADMIT
        obs_trace.instant(
            "submit",
            "admission",
            pid="serving",
            tid=tenant_id,
            tenant=tenant_id,
            num_updates=len(updates),
            admitted=decision.admitted,
            reason=decision.reason,
        )
        if not decision.admitted:
            return SubmitResult(False, decision.reason, st.watermark)
        self._admitted_total += len(updates)
        st.watermark = self._admitted_total
        self._queue.extend(updates)
        if self._wake is not None:
            self._wake.set()
            self._idle.clear()
        return SubmitResult(True, decision.reason, st.watermark)

    # ----------------------------------------------------------------- reads
    async def read(
        self,
        ticket: QueryTicket,
        *,
        timeout_s: float | None = None,
        require: int | None = None,
    ) -> ReadResult:
        """Serve the ticket's answers from the epoch view.

        Waits (up to ``timeout_s``) until the applied prefix covers the
        tenant's watermark — read-your-writes.  On timeout the current
        epoch is served anyway, marked ``fresh=False``."""
        self._raise_if_failed()
        t0 = self.clock()
        st = self.registry.require(ticket.tenant_id)
        required = st.watermark if require is None else int(require)
        if self._covered < required:
            fut = asyncio.get_running_loop().create_future()
            self._waiters.append((required, fut))
            limit = (
                self.config.read_timeout_s if timeout_s is None else timeout_s
            )
            try:
                await asyncio.wait_for(fut, limit)
            except asyncio.TimeoutError:
                pass
        self._raise_if_failed()
        values = self._view.get(ticket.ticket_id)
        if values is None:
            raise ValueError(
                f"ticket {ticket.ticket_id} has no registered query"
            )
        wait_s = self.clock() - t0
        covered = self._covered
        fresh = covered >= required
        tid = ticket.tenant_id
        self.metrics.record("read", wait_s)
        self._read_wait.setdefault(tid, []).append(wait_s)
        self._read_lag.setdefault(tid, []).append(max(required - covered, 0))
        if not fresh:
            self._stale_reads[tid] = self._stale_reads.get(tid, 0) + 1
        return ReadResult(
            values=values, epoch=self._epoch, covered=covered,
            required=required, fresh=fresh, wait_s=wait_s,
        )

    # ------------------------------------------------------------ the loop
    async def _ingest_loop(self) -> None:
        try:
            while True:
                await self._wait_for_work()
                if (
                    self._stopping
                    and not self._queue
                    and not self._control
                ):
                    break
                t0 = self.clock()
                await self._run_control_ops()
                chunk = [
                    self._queue.popleft()
                    for _ in range(
                        min(len(self._queue), self.config.chunk_updates)
                    )
                ]
                self.metrics.record("ingest", self.clock() - t0)
                if chunk:
                    await self._apply_chunk(chunk)
                if not self._queue and not self._control:
                    self._idle.set()
        except BaseException as e:
            self._failure = e
            self._fail_waiters(e)
            self._idle.set()
            raise
        finally:
            self._idle.set()

    async def _wait_for_work(self) -> None:
        while not self._stopping and not self._queue and not self._control:
            self._idle.set()
            self._wake.clear()
            await self._wake.wait()
        if (
            not self._stopping
            and self.config.flush_interval_s > 0
            and not self._control
            and 0 < len(self._queue) < self.config.chunk_updates
        ):
            await asyncio.sleep(self.config.flush_interval_s)

    async def _run_control_ops(self) -> None:
        loop = asyncio.get_running_loop()
        while self._control:
            kind, payload, fut = self._control.popleft()
            try:
                if kind == "register":
                    tenant_id, plan = payload
                    t0 = self.clock()
                    handle = await loop.run_in_executor(
                        None, self.session.register, plan
                    )
                    self.metrics.record("register", self.clock() - t0)
                    ticket = self.registry.new_ticket(tenant_id)
                    base = plan.drop if plan.drop is not None else dr.DropConfig()
                    self.registry.attach(ticket, handle.qid, base)
                    self._plans[ticket.ticket_id] = plan
                    self._control_log.append(
                        {"cursor": len(self._chunk_log), "kind": "register",
                         "ticket_id": ticket.ticket_id,
                         "tenant_id": tenant_id, "qid": handle.qid}
                    )
                    st = self.registry.require(tenant_id)
                    if st.level > 0:  # join the tenant at its current rung
                        self.registry._apply_level(self.session, st, st.level)
                    # the registration sweep computed answers — view them now
                    self._view[ticket.ticket_id] = np.array(
                        self.session.answers(handle), copy=True
                    )
                    if not fut.done():
                        fut.set_result(ticket)
                elif kind == "deregister":
                    freed = self._detach_ticket(payload)
                    if not fut.done():
                        fut.set_result(freed)
                else:  # pragma: no cover - defensive
                    raise ValueError(f"unknown control op {kind!r}")
            except AdmissionRejected as e:
                if not fut.done():
                    fut.set_exception(e)
            except Exception as e:  # noqa: BLE001 - surface to the caller
                if not fut.done():
                    fut.set_exception(e)

    def _apply_sync(self, chunk: list, k: int) -> None:
        if self.delay_injector is not None:
            delay = self.delay_injector(k)
            if delay:
                time.sleep(delay)
        self.session.apply_updates_batched(
            chunk, batch_size=self.config.chunk_updates
        )

    async def _apply_chunk(self, chunk: list) -> None:
        loop = asyncio.get_running_loop()
        k = len(self._chunk_log)
        while True:
            try:
                if self.fault_injector is not None:
                    self.fault_injector(k)
                t0 = self.clock()
                await loop.run_in_executor(None, self._apply_sync, chunk, k)
                maintain_s = self.clock() - t0
                break
            except (InjectedFault, RuntimeError) as e:
                await self._recover(e, k)
        self._chunk_log.append(chunk)
        self._covered += len(chunk)
        self._epoch += 1
        self.metrics.record("maintain", maintain_s)
        self._refresh_view()
        self.straggler.observe(k, maintain_s)
        if self.config.admission:
            self.admission.observe_epoch(
                maintain_s,
                headroom_frac=self._headroom_frac(),
                backlog_updates=len(self._queue),
            )
            self.admission.regulate(self.session)
            self._settle_pending_registers()
        self.registry.enforce_budgets(self.session)
        self._notify_waiters()
        await self._maybe_checkpoint()
        if self._epoch % max(int(self.config.obs_every), 1) == 0:
            self._obs_scrape()

    def _obs_scrape(self) -> None:
        """Periodic observability tick: publish the session into the obs
        registry, then rewrite the configured file sinks (per-epoch trace
        flush + metrics snapshot).  Sink errors never take down serving."""
        try:
            self.session.publish_metrics()
            reg = obs_metrics.get_registry()
            reg.gauge("serving_epoch", "applied epoch counter").set(self._epoch)
            reg.gauge("serving_queue_depth", "admitted updates not yet applied").set(
                len(self._queue)
            )
            reg.gauge(
                "serving_covered_updates", "applied prefix of the admitted stream"
            ).set(self._covered)
            if self.config.metrics_out:
                with open(self.config.metrics_out, "w") as f:
                    json.dump(reg.snapshot(), f, indent=1)
            if self.config.trace_out:
                obs_trace.get_tracer().export(self.config.trace_out)
        except Exception:  # pragma: no cover - diagnostics must not kill serving
            pass

    def _headroom_frac(self) -> float | None:
        governor = getattr(self.session, "_governor", None)
        if governor is None:
            return None
        return governor.headroom_fraction(self.session)

    def _refresh_view(self) -> None:
        by_qid = self.session.answers_snapshot()
        for st in self.registry.tenants():
            for ticket_id, qid in st.qids.items():
                if qid in by_qid:
                    self._view[ticket_id] = by_qid[qid]

    def _notify_waiters(self) -> None:
        still = []
        for required, fut in self._waiters:
            if fut.done():
                continue
            if self._covered >= required:
                fut.set_result(self._covered)
            else:
                still.append((required, fut))
        self._waiters = still

    def _fail_waiters(self, exc: BaseException) -> None:
        for _, fut in self._waiters:
            if not fut.done():
                fut.set_exception(exc)
        self._waiters = []
        for _, _, fut in self._pending_registers:
            if not fut.done():
                fut.set_exception(exc)
        self._pending_registers.clear()
        while self._control:
            _, _, fut = self._control.popleft()
            if not fut.done():
                fut.set_exception(exc)

    def _settle_pending_registers(self) -> None:
        if not self._pending_registers:
            return
        if self.admission.shedding:
            while self._pending_registers:
                tenant_id, _, fut = self._pending_registers.popleft()
                st = self.registry.require(tenant_id)
                st.rejected_registers += 1
                self.admission.rejected_registers += 1
                if not fut.done():
                    fut.set_exception(
                        AdmissionRejected(Decision("reject", "overload shed"))
                    )
        elif not self.admission.overloaded():
            while self._pending_registers:
                tenant_id, plan, fut = self._pending_registers.popleft()
                self._control.append(("register", (tenant_id, plan), fut))

    # ------------------------------------------------------------ durability
    def _serving_extra(self) -> dict:
        return {
            "serving": {
                "tenants": self.registry.state_dict(),
                "admission": self.admission.state_dict(),
                "admitted_total": self._admitted_total,
                "covered": self._covered,
                "epoch": self._epoch,
            }
        }

    async def _maybe_checkpoint(self) -> None:
        if self.supervisor is None or not self.config.checkpoint_every:
            return
        k = len(self._chunk_log)
        if k % self.config.checkpoint_every != 0:
            return
        loop = asyncio.get_running_loop()
        t0 = self.clock()
        await loop.run_in_executor(
            None,
            lambda: self.supervisor.checkpoint(
                self.session, k, extra=self._serving_extra()
            ),
        )
        self.metrics.record("checkpoint", self.clock() - t0)

    def checkpoint_now(self) -> None:
        """Synchronous on-demand checkpoint (drain the loop first)."""
        if self.supervisor is None:
            raise RuntimeError("server was built without a checkpoint_dir")
        self.supervisor.checkpoint(
            self.session, len(self._chunk_log), extra=self._serving_extra()
        )

    def _restore_fn(self, directory: str | None) -> tuple[CQPSession, int]:
        if directory is None:
            return self._genesis()
        # the restore reads only what reached the disk, onto the device the
        # serving session runs on
        session = CQPSession.restore(directory, mesh=self.mesh, device=self.session.device)
        extra = (session.restore_info or {}).get("extra") or {}
        return session, int(extra.get("next_chunk", 0))

    def _genesis(self) -> tuple[CQPSession, int]:
        """Rebuild from scratch: a fresh session with every live query
        re-registered in ticket order; ticket → qid mappings are remapped
        (qids are NOT stable across a genesis rebuild — tickets are)."""
        if self.session_factory is None:
            raise RuntimeError(
                "no checkpoint on disk and no session_factory to rebuild "
                "from genesis"
            )
        session = self.session_factory()
        mapping: dict[int, int] = {}
        for st in self.registry.tenants():
            for ticket_id in sorted(st.qids):
                handle = session.register(self._plans[ticket_id])
                mapping[st.qids[ticket_id]] = handle.qid
        self.registry.remap_qids(mapping)
        return session, 0

    async def _recover(self, exc: BaseException, k: int) -> None:
        """Restore (checkpoint or genesis), replay control ops + chunks up
        to the failed chunk, resume.  Raises once restarts are exhausted."""
        self.faults += 1
        loop = asyncio.get_running_loop()
        if self.supervisor is not None:
            self.supervisor.record_fault(k, exc)
            session, cursor = await loop.run_in_executor(
                None, lambda: self.supervisor.restore_latest(fault_chunk=k)
            )
        else:
            self._restarts += 1
            if self._restarts > self._policy.max_restarts:
                raise exc
            if self._policy.backoff_s:
                await asyncio.sleep(self._policy.backoff_s)
            session, cursor = self._genesis()
        await loop.run_in_executor(
            None, self._adopt_session, session, cursor
        )

    def _adopt_session(self, session: CQPSession, cursor: int) -> None:
        # 1. replay the control ops the restored state predates.  The
        # checkpoint carries the session's qid cursor, so re-running the
        # post-checkpoint registers in order reassigns the SAME qids the
        # originals got; the genesis path instead re-registered every live
        # ticket already (remapped qids), so its replay is a no-op — both
        # cases fall out of the `have` membership checks below.
        have = {h.qid for h in session.handles()}
        for op in self._control_log:
            if op["cursor"] <= cursor and cursor > 0:
                continue
            if op["kind"] == "register":
                ticket_id = op["ticket_id"]
                st = self.registry.require(op["tenant_id"])
                if ticket_id not in st.qids:
                    continue  # later deregistered — replay will drop it too
                if st.qids[ticket_id] in have:
                    continue  # already present (checkpoint or genesis)
                handle = session.register(self._plans[ticket_id])
                st.qids[ticket_id] = handle.qid
                have.add(handle.qid)
            else:
                qid = op["qid"]
                if qid in have:
                    handle = next(
                        h for h in session.handles() if h.qid == qid
                    )
                    session.deregister(handle)
                    have.discard(qid)
        # 2. re-apply degradation rungs the checkpoint predates
        for st in self.registry.tenants():
            if st.level > 0 and st.qids:
                self.registry._apply_level(session, st, st.level)
        # 3. replay the δE chunk log suffix
        for chunk in self._chunk_log[cursor:]:
            session.apply_updates_batched(
                chunk, batch_size=self.config.chunk_updates
            )
        session.attach_runtime(
            straggler=self.straggler, supervisor=self.supervisor
        )
        self.session = session
        self._refresh_view()

    # ------------------------------------------------------------- runtime
    def _on_straggler(self, event) -> None:
        """The straggler policy: one out-of-band ladder escalation."""
        if self.config.admission:
            self.admission.force_shed(
                self.session, f"straggler@{event.step}"
            )

    # ------------------------------------------------------------ reporting
    def applied_updates(self) -> list:
        """The applied δE prefix, flattened — the scratch oracle's input."""
        return [u for chunk in self._chunk_log for u in chunk]

    def stats(self) -> dict:
        per_tenant = self.registry.snapshot()
        for tid in per_tenant:
            per_tenant[tid]["read_latency"] = summarize_latency_s(
                self._read_wait.get(tid, ())
            )
            lags = self._read_lag.get(tid, ())
            per_tenant[tid]["freshness_lag_updates"] = {
                "mean": float(np.mean(lags)) if lags else 0.0,
                "max": int(max(lags)) if lags else 0,
            }
            per_tenant[tid]["stale_reads"] = self._stale_reads.get(tid, 0)
        out = {
            "epochs": self._epoch,
            "covered_updates": self._covered,
            "admitted_total": self._admitted_total,
            "queue_depth": len(self._queue),
            "chunks_applied": len(self._chunk_log),
            "faults": self.faults,
            "tenants": per_tenant,
            "admission": self.admission.snapshot(),
            "actions": list(self.registry.actions),
            "phases": self.metrics.summary(),
            "straggler_events": len(self.straggler.events),
            "session": self.session.stats(),
        }
        if self.supervisor is not None:
            out["recovery"] = self.supervisor.metrics()
        return out


# ------------------------------------------------------------------ CLI smoke
def _scripted_scenario(args: argparse.Namespace) -> dict:
    """Deterministic multi-tenant scenario: register one SSSP query per
    tenant, stream the update log round-robin, optionally inject one fault
    mid-stream (restore + replay), check every served answer bit for bit
    against a scratch oracle, deregister everyone."""
    from repro_torch.core import plan
    from repro_torch.data.graphgen import powerlaw_graph, split_90_10, update_stream
    from repro_torch.launch.cqp_serve import mesh_of

    edges = powerlaw_graph(args.v, args.e, seed=args.seed)
    initial, pool = split_90_10(edges, seed=args.seed)
    stream = update_stream(
        initial,
        args.v,
        num_batches=max(1, args.updates // max(args.batch, 1)),
        batch_size=args.batch,
        insert_pool=pool,
        delete_fraction=0.1,
        seed=args.seed + 1,
    )
    log = [u for batch in stream for u in batch]
    mesh = mesh_of(args)
    ladder = GovernorConfig(representation="prob")

    def fresh_graph() -> DynamicGraph:
        return DynamicGraph(args.v, initial, capacity=len(edges) * 4 + 64)

    def factory() -> CQPSession:
        return build_serving_session(
            fresh_graph(),
            ladder=ladder,
            engine=args.engine,
            mesh=mesh,
            batch_capacity=args.batch,
            min_slots=args.tenants,
            device=args.device,
        )

    if args.trace_out:
        obs_trace.set_tracer(obs_trace.Tracer())
    cfg = ServerConfig(
        chunk_updates=args.batch,
        admission=not args.no_admission,
        slo=SLOConfig(backlog_high_updates=max(8 * args.batch, 256)),
        drop_ladder=ladder,
        checkpoint_every=args.checkpoint_every,
        max_restarts=3,
        trace_out=args.trace_out,
        metrics_out=args.metrics_out,
    )
    fault_at = args.inject_fault_at
    fired = {"done": False}

    def injector(k: int) -> None:
        if fault_at is not None and k == fault_at and not fired["done"]:
            fired["done"] = True
            raise InjectedFault(f"scripted fault at chunk {k}")

    async def run() -> dict:
        server = CQPServer(
            factory(),
            config=cfg,
            session_factory=factory,
            checkpoint_dir=args.checkpoint_dir,
            mesh=mesh,
            fault_injector=injector if fault_at is not None else None,
        )
        async with server:
            tickets = []
            for i in range(args.tenants):
                tid = f"tenant{i}"
                server.add_tenant(TenantSpec(tenant_id=tid, priority=i + 1))
                ticket = await server.register_query(
                    tid, plan.sssp(i % args.v, max_iters=args.max_iters)
                )
                tickets.append((tid, ticket))
            # round-robin the update stream across tenants
            for i in range(0, len(log), args.batch):
                tid, _ = tickets[(i // args.batch) % len(tickets)]
                server.submit(tid, log[i : i + args.batch])
            await server.drain()
            reads = [await server.read(ticket, timeout_s=60.0) for _, ticket in tickets]
            fresh = all(r.fresh for r in reads)
            # scratch oracle over the applied log — every served answer
            # equal bit for bit (min family)
            oracle = CQPSession(fresh_graph(), engine="scratch", device=args.device)
            handles = [oracle.register(server._plans[t.ticket_id]) for _, t in tickets]
            oracle.apply_updates_batched(server.applied_updates())
            exact = all(
                np.array_equal(r.values, oracle.answers(h), equal_nan=True)
                for r, h in zip(reads, handles)
            )
            for tid, _ in tickets:
                await server.remove_tenant(tid)
            stats = server.stats()
        stats["exact"] = bool(exact)
        stats["ok"] = bool(
            exact
            and fresh
            and stats["session"]["active_queries"] == 0
            and (fault_at is None or stats["faults"] >= 1)
        )
        return stats

    return asyncio.run(run())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Async multi-tenant CQP serving scenario "
        "(python -m repro_torch.serving.server)"
    )
    ap.add_argument("--smoke", action="store_true", help="tiny deterministic run")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--v", type=int, default=256)
    ap.add_argument("--e", type=int, default=1024)
    ap.add_argument("--updates", type=int, default=192)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-iters", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="dense", choices=["dense", "host"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                    "the plain PyTorch versions)")
    ap.add_argument("--mesh", default="none", choices=["none", "smoke", "data"],
                    help="dense-engine mesh: none (unsharded), smoke (one shard) or "
                    "data (the vertex-sharded sweep over --shards cards)")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--emulate-devices", type=int, default=0,
                    help="emulate N devices on --device for --mesh data")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--no-admission", action="store_true",
                    help="control run: no admission/shedding")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="enable the tracer; flush a Chrome-trace JSON per obs scrape")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS_JSON",
                    help="write obs registry snapshots per scrape")
    ap.add_argument("--json", action="store_true", help="print the full stats")
    args = ap.parse_args(argv)
    if args.emulate_devices and args.mesh != "data":
        ap.error("--emulate-devices needs --mesh data")
    if args.smoke:
        args.v = min(args.v, 64)
        args.e = min(args.e, 256)
        args.updates = min(args.updates, 96)
        args.max_iters = min(args.max_iters, 16)
    stats = _scripted_scenario(args)
    recovery = stats.get("recovery", {})
    summary = {
        "ok": stats["ok"],
        "exact": stats["exact"],
        "tenants": args.tenants,
        "epochs": stats["epochs"],
        "covered_updates": stats["covered_updates"],
        "faults": stats["faults"],
        "restores": len(recovery.get("restores", [])),
        "history": recovery.get("history", []),
    }
    print("serving smoke JSON:", json.dumps(summary))
    if args.json:
        print(json.dumps(stats, indent=2, default=str))
    return 0 if stats["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
