"""Heartbeats, straggler mitigation and the restart policy (copies)."""
