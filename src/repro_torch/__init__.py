"""Percepta in PyTorch: the port of the ``repro`` JAX package to CUDA.

The layout mirrors ``repro/`` module for module. Plain tensor code is
PyTorch; the three kernels the decision loop reaches (``kernels/locf``,
``kernels/window_agg``, ``kernels/rglru_scan``) are hand-written CUDA C++
for Hopper (``sm_90a``), built by ``kernels/_build.py`` at first use. This
package imports neither ``jax`` nor any module of ``repro``.
"""
from repro_torch.device import resolve_device  # noqa: F401
