"""PyTorch / CUDA port of the CXL-GPU reproduction (``repro``).

The package mirrors ``src/repro`` path for path. It imports ``torch`` and
numpy only — never ``jax`` and nothing of the JAX package, whose pure-Python
modules (simulator, tier, scheduler, configs) are kept here as copies so
that the port runs on a machine without JAX. Kernels that the JAX package
wrote in Pallas for the TPU are CUDA C++ for Hopper (``csrc/``), each with a
plain PyTorch version beside its wrapper (``kernels/*/ref.py``).
"""
