"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts kernel launches. Any width W is
taken as it is: the TPU's padding of W to 128 lanes has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

LAUNCHES = 0


def rglru_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: (B, T, W) float32;
    h0: (B, W) float32. Returns (hs (B, T, W), h_last (B, W))."""
    global LAUNCHES
    B, T, W = a.shape
    dev = a.device
    _build.require("a", a, torch.float32, (B, T, W), dev)
    _build.require("b", b, torch.float32, (B, T, W), dev)
    _build.require("h0", h0, torch.float32, (B, W), dev)
    if dev.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {dev}")
    if B * T * W >= 2 ** 31:
        raise ValueError(f"rglru_scan: B*T*W = {B * T * W} elements; the "
                         "kernel indexes in 32 bits (< 2^31)")
    lib = _build.library()
    hs = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    with _build.on_device(dev):
        _build.check(lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            h_last.data_ptr(), B, T, W, _build.stream_ptr(dev)), "rglru_scan")
    LAUNCHES += 1
    return hs, h_last
