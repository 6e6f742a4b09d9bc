"""Asynchronous checkpoints of a training state."""
