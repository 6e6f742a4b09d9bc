"""The deterministic token pipeline."""
