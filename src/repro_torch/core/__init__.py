"""QoS, deterministic store and the CXL-timed tier (copies)."""
