"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``*.cu`` source compiles to an object with ``nvcc`` for ``sm_90a``,
all sources at once in parallel, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use into ``build/kernels/<digest>/`` at the repository root (the
digest covers the sources and flags, so an edited source rebuilds), and
never while a module is imported: the CPU tests import every module and
have no ``nvcc``. Nothing links ``-lcuda``: the Hopper prefill instance
takes ``cuTensorMapEncodeTiled`` (its TMA descriptors) from the driver at
run time through ``cudaGetDriverEntryPoint`` (``csrc/flash_prefill.cu``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

# dtype codes of the C entries (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_paged_decode": [_P] * 10 + [_I] * 15 + [_F, _F, _P],
    "repro_paged_decode_int8": [_P] * 15 + [_I] * 15 + [_F, _F, _P],
    "repro_flash_prefill": [_P] * 5 + [_I] * 7 + [_F, _F] + [_I] * 4 + [_P],
    "repro_ssd_scan": [_P] * 10 + [_I] * 8 + [_P],
    "repro_paged_matmul": [_P] * 6 + [_I] * 13 + [_P],
}

_LIB = None


def _nvcc() -> str:
    path = os.environ.get("NVCC") or shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (set NVCC or PATH)")
    return path


def sources(csrc: Path = CSRC, names=None):
    """The kernel sources of ``csrc`` (those whose stem is in ``names``,
    where given), in a stable order."""
    return [p for p in sorted(csrc.glob("*.cu"))
            if names is None or p.stem in names]


def build_dir(csrc: Path = CSRC, names=None) -> Path:
    """Where this exact set of sources, headers and flags builds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cuh")) + sources(csrc, names):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(csrc: Path = CSRC, names=None) -> Path:
    """Compile every source of ``csrc`` (or those named; in parallel) and
    link ``libreprokernels.so``; returns its path. Compiler output, ptxas
    register and shared-memory reports included, lands in ``build.log``
    beside it."""
    out = build_dir(csrc, names)
    lib = out / "libreprokernels.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources(csrc, names):
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = out / f"libreprokernels.{os.getpid()}.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp)]
            + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    (out / "build.log").write_text("\n".join(log))
    if failed:
        print("\n".join(log))
        raise RuntimeError(f"kernel build failed: {failed}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad is enabled and any of ``tensors`` requires it: a
    kernel wrapper allocates its outputs outside autograd, so a backward
    through it would drop the gradient silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad")
