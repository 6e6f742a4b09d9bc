"""Serving: config, stats, scheduler and the continuous-batching engine."""
