"""Synthetic dynamic-graph workloads (numpy only)."""
