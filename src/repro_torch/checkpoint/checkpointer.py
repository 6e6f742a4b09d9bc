"""Asynchronous checkpoints of a flat name -> tensor map.

The deterministic-store discipline applied to persistence: a step's state
is "complete" once it is snapshotted to host memory (a copy of each
tensor, off the step path); the serialization to disk drains in a
background thread, and a checkpoint becomes visible only when its
directory is atomically renamed into place -- a crash mid-write never
yields a half checkpoint. The layout, the ``keep`` GC and the commit are
the reference's (``repro/checkpoint/checkpointer.py``); the state is a
flat ``state_dict``-style map (names to tensors, numpy arrays or ``None``)
instead of a pickled pytree, so the two formats do not read each other.

Layout: ``<dir>/step_<n>/{manifest.json, leaf_<i>.npy}``. numpy has no
bf16, so a bf16 tensor is saved as its 16 bits (int16) and the manifest
records each leaf's dtype, which restore views the bits back as.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

def _snapshot(value) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """(host array, dtype name) of one leaf; bf16 as its 16 bits."""
    if value is None:
        return None, None
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    arr = np.array(value, copy=True)
    return arr, str(arr.dtype)


def _restore_leaf(arr: np.ndarray, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))   # 0-d stays 0-d
    want = getattr(torch, name)
    if want == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(want).to(device)


class Checkpointer:
    """Directory layout: ``<dir>/step_<n>/{manifest.json, leaf_<i>.npy}``."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None, blocking: bool = False) -> None:
        """Snapshot now (to host memory), write in the background (async
        by default)."""
        self.wait()
        names = list(state)
        snaps = [_snapshot(state[n]) for n in names]
        payload = (step, names, snaps, extra or {})
        self._thread = threading.Thread(target=self._write, args=(payload,),
                                        daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, payload: Tuple) -> None:
        step, names, snaps, extra = payload
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (arr, _) in enumerate(snaps):
            if arr is not None:
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest = {"step": step, "names": names,
                    "none_leaves": [i for i, (a, _) in enumerate(snaps)
                                    if a is None],
                    "dtypes": [d for _, d in snaps], "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                device="cpu") -> Tuple[int, Dict[str, Any], Dict]:
        """Returns (step, state, extra): every leaf a tensor of its saved
        dtype on ``device`` (host memory unless asked), ``None`` leaves
        ``None``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        none_set = set(manifest["none_leaves"])
        state = {}
        for i, (name, dt) in enumerate(zip(manifest["names"],
                                           manifest["dtypes"])):
            state[name] = None if i in none_set else _restore_leaf(
                np.load(os.path.join(path, f"leaf_{i}.npy")), dt, device)
        return step, state, manifest["extra"]
