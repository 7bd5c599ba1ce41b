"""Recovery supervisor for the serving loop — ``fault.Supervisor``'s CQP twin.

The port of ``repro/runtime/recovery.py``.

The training supervisor restores a *state pytree*; a CQP restart must rebuild
a whole session (host graph, plans, engine, governor) and re-ingest the
suffix of the update log.  ``RecoverySupervisor`` owns that loop:

* periodic checkpoints every ``policy.checkpoint_every`` chunks through an
  async keep-N :class:`~repro_torch.checkpoint.CheckpointManager`, with the log
  cursor riding in the manifest meta;
* on fault (``InjectedFault`` or any ``RuntimeError``, which in PyTorch
  includes CUDA errors and ``torch.OutOfMemoryError``): restart backoff,
  ``max_restarts`` exhaustion re-raises, then ``restore_fn`` rebuilds the
  session from the latest checkpoint (or from genesis when none landed yet)
  and the loop resumes at the restored cursor — deterministic replay makes
  the answers bit-identical to an uninterrupted run (DESIGN.md §12);
* an optional :class:`~repro_torch.runtime.straggler.StragglerDetector` observes
  per-chunk wall time.

``restore_fn(directory | None) -> (session, next_chunk)`` is the caller's
rebuild hook: with a directory it should ``CQPSession.restore`` and read the
cursor from ``restore_info``; with ``None`` (no checkpoint on disk yet) it
rebuilds from genesis at chunk 0.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import FaultPolicy, InjectedFault
from repro_torch.runtime.straggler import StragglerDetector

log = logging.getLogger("repro_torch.recovery")


class RecoverySupervisor:
    """Checkpoint/restart supervisor for a ``CQPSession`` serving loop."""

    def __init__(
        self,
        directory: str,
        policy: FaultPolicy | None = None,
        *,
        keep: int = 3,
        async_write: bool = True,
        restore_fn: Callable[[str | None], tuple[object, int]],
        fault_injector: Callable[[int], None] | None = None,
        straggler: StragglerDetector | None = None,
    ) -> None:
        self.manager = CheckpointManager(directory, keep=keep, async_write=async_write)
        self.policy = policy if policy is not None else FaultPolicy()
        self.restore_fn = restore_fn
        self.fault_injector = fault_injector
        self.straggler = straggler
        self.restarts = 0
        self.history: list[str] = []
        self.checkpoints = 0
        self.checkpoint_s: list[float] = []
        # each checkpoint's wall split: the session's state_dict (device →
        # host copies) and the wait on the previous in-flight write
        self.checkpoint_state_s: list[float] = []
        self.checkpoint_wait_s: list[float] = []
        self.checkpoint_bytes = 0  # host bytes of the last snapshot taken
        self.restores: list[dict] = []

    # ------------------------------------------------------------------ api
    def checkpoint(
        self, session, next_chunk: int, *, extra: dict | None = None
    ) -> None:
        """Snapshot ``session`` with the log cursor ``next_chunk``; ``extra``
        entries ride along in the manifest meta (the serving tier stores its
        tenant registry there)."""
        t0 = time.perf_counter()
        with obs_trace.span(
            "checkpoint", "checkpoint", pid="recovery", next_chunk=int(next_chunk)
        ) as sp:
            user = {"next_chunk": int(next_chunk)}
            if extra:
                user.update(extra)
            arrays, meta = session.state_dict(extra=user)
            self.checkpoint_state_s.append(time.perf_counter() - t0)
            self.checkpoint_bytes = sum(int(a.nbytes) for a in arrays.values())
            waited = len(self.manager.wait_s)
            self.manager.save(next_chunk, arrays, meta=meta)
            self.checkpoint_wait_s.append(sum(self.manager.wait_s[waited:]))
            sp.set(nbytes=self.checkpoint_bytes)
        dt = time.perf_counter() - t0
        self.checkpoint_s.append(dt)
        self.checkpoints += 1
        self.history.append(f"ckpt@{next_chunk}")
        reg = obs_metrics.get_registry()
        reg.counter("cqp_checkpoints_total", "checkpoints written").inc()
        reg.counter(
            "cqp_checkpoint_bytes_total", "host bytes snapshotted"
        ).inc(self.checkpoint_bytes)
        reg.histogram(
            "cqp_checkpoint_seconds", "checkpoint write latency"
        ).observe(dt)
        reg.gauge(
            "cqp_checkpoint_last_bytes", "host bytes of the last snapshot"
        ).set(self.checkpoint_bytes)

    def run(
        self,
        session,
        chunks: list,
        step_fn: Callable[[object, int, object], None],
        *,
        start_chunk: int = 0,
    ):
        """Drive ``step_fn(session, k, chunks[k])`` over the log with
        checkpoint-every-K and restart-on-fault; returns the final session."""
        k = int(start_chunk)
        n = len(chunks)
        every = self.policy.checkpoint_every
        while k < n:
            try:
                if self.fault_injector is not None:
                    self.fault_injector(k)
                t0 = time.perf_counter()
                step_fn(session, k, chunks[k])
                if self.straggler is not None:
                    self.straggler.observe(k, time.perf_counter() - t0)
                k += 1
                if every and k % every == 0:
                    self.checkpoint(session, k)
            except (InjectedFault, RuntimeError) as e:
                self.record_fault(k, e)
                session, k = self.restore_latest(fault_chunk=k)
        self.manager.wait()
        return session

    def record_fault(self, chunk: int, exc: BaseException) -> None:
        """Account one serving-loop fault; re-raises it once the restart
        budget is spent, after sleeping the restart backoff otherwise."""
        self.restarts += 1
        self.history.append(f"fault@{chunk}:{type(exc).__name__}")
        log.warning(
            "chunk %d failed (%s); restart %d", chunk, exc, self.restarts
        )
        if self.restarts > self.policy.max_restarts:
            raise exc
        if self.policy.backoff_s:
            time.sleep(self.policy.backoff_s)

    def restore_latest(self, *, fault_chunk: int) -> tuple[object, int]:
        """Rebuild via ``restore_fn`` from the latest on-disk checkpoint
        (or genesis when none landed yet); returns (session, next_chunk).
        The async serving tier calls this directly — its ingest loop is not
        a static chunk list, so it cannot run under :meth:`run`."""
        self.manager.wait()  # never restore past an in-flight write
        t0 = time.perf_counter()
        with obs_trace.span(
            "restore", "checkpoint", pid="recovery", fault_chunk=int(fault_chunk)
        ) as sp:
            try:
                session, k = self.restore_fn(self.manager.directory)
            except FileNotFoundError:
                # no checkpoint landed yet → rebuild from genesis
                session, k = self.restore_fn(None)
            sp.set(resumed_chunk=int(k), replayed_chunks=int(fault_chunk - k))
        dt = time.perf_counter() - t0
        self.restores.append({
            "latency_s": dt,
            "resumed_chunk": int(k),
            "replayed_chunks": int(fault_chunk - k),
        })
        self.history.append(f"resume@{k}")
        reg = obs_metrics.get_registry()
        reg.counter("cqp_restores_total", "checkpoint restores").inc()
        reg.histogram(
            "cqp_restore_seconds", "restore latency (rebuild + replay cursor)"
        ).observe(dt)
        reg.counter(
            "cqp_replayed_chunks_total", "log chunks replayed after restores"
        ).inc(max(int(fault_chunk - k), 0))
        return session, k

    def metrics(self) -> dict:
        """Recovery counters for ``session.stats()["runtime"]`` / reports."""
        return {
            "restarts": self.restarts,
            "checkpoints": self.checkpoints,
            "checkpoint_s": list(self.checkpoint_s),
            "checkpoint_state_s": list(self.checkpoint_state_s),
            "checkpoint_wait_s": list(self.checkpoint_wait_s),
            "checkpoint_write_s": list(self.manager.write_s),
            "checkpoint_bytes": self.checkpoint_bytes,
            "restores": list(self.restores),
            "replayed_chunks": sum(r["replayed_chunks"] for r in self.restores),
            "history": list(self.history),
        }
