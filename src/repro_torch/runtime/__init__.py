"""Serving runtime: fault supervision, recovery of a CQP session, straggler
detection, and elastic resharding of a sharded engine (``runtime.elastic``)."""
