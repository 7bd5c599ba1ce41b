"""Observability: the span tracer (``obs.trace``), the typed metrics
registry (``obs.metrics``) and the DC probes over a session
(``obs.probes``)."""
