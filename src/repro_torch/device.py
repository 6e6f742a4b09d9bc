"""Device selection shared by every entry point of the port.

Entry points default to ``device="cuda"``. Without a card they raise rather
than fall back: the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU")
    return dev
