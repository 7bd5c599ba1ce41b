"""Observability: the span tracer (``obs.trace``)."""
