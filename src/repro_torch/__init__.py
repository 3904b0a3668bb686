"""PyTorch/CUDA port of the BiSupervised cascade (``repro``) for one
NVIDIA H100.

Mirrors ``repro``'s layout (configs, data, core, models, kernels, runtime,
serving, train, launch) and its parameter trees. Imports ``torch`` and
never ``jax`` or ``repro``. Hand-written CUDA kernels for sm_90a live in
``csrc/`` and build at first use (``kernels/build.py``).
"""
