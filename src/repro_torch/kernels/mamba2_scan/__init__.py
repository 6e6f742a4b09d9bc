"""Chunked Mamba2 SSD scan with a carried f32 state."""
