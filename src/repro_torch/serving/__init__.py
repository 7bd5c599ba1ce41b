"""Async multi-tenant CQP serving tier (DESIGN.md §14), the port of
``repro/serving``.

A long-running asyncio front end over
:class:`repro_torch.core.session.CQPSession`:

* :mod:`repro_torch.serving.server` — the ingest loop (batched δE folds through
  ``apply_updates_batched``) with snapshot-consistent epoch reads, wired to
  the recovery supervisor, straggler detector, and checkpoint/restore;
* :mod:`repro_torch.serving.tenants` — per-tenant registries: query tickets,
  isolated governor byte budgets, and rate quotas;
* :mod:`repro_torch.serving.admission` — SLO-based admission control with a
  graceful-degradation ladder (degrade low-priority tenants before
  rejecting anyone);
* :mod:`repro_torch.serving.loadgen` — multi-tenant open-loop load generator;
* :mod:`repro_torch.serving.metrics` — shared latency/percentile reporting.
"""

# Lazy re-exports (PEP 562): importing `repro_torch.serving.metrics` or
# `.tenants` must not pull in `.server` and, through it, the whole engine.
import importlib

_EXPORTS = {
    "AdmissionController": "admission",
    "AdmissionRejected": "admission",
    "Decision": "admission",
    "SLOConfig": "admission",
    "PhaseRecorder": "metrics",
    "summarize_latency_s": "metrics",
    "CQPServer": "server",
    "ReadResult": "server",
    "ServerConfig": "server",
    "SubmitResult": "server",
    "build_serving_session": "server",
    "QueryTicket": "tenants",
    "TenantRegistry": "tenants",
    "TenantSpec": "tenants",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        module = importlib.import_module(f"repro_torch.serving.{_EXPORTS[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'repro_torch.serving' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "CQPServer",
    "Decision",
    "PhaseRecorder",
    "QueryTicket",
    "ReadResult",
    "SLOConfig",
    "ServerConfig",
    "SubmitResult",
    "TenantRegistry",
    "TenantSpec",
    "build_serving_session",
    "summarize_latency_s",
]
