"""Serving runtime: fault supervision, recovery of a CQP session, straggler
detection.  The mesh rules and elastic resharding come with the sharded
slice of the port (ROADMAP Queue 1 item 4)."""
