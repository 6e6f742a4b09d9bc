"""Paged flash-decode: per-slot single-token attention over KV pages."""
