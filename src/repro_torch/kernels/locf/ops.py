"""Wrapper of the LOCF kernel (``csrc/locf.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.locf.ref import locf_ref

LAUNCHES = 0


def locf(values, observed, init_value, init_has):
    """Batched entry: values/observed (E, S, T) float32/bool, carry-in
    init_value/init_has (E, S) float32/bool. Returns (filled, has), both
    (E, S, T)."""
    global LAUNCHES
    E, S, T = values.shape
    dev = values.device
    _build.require("values", values, torch.float32, (E, S, T), dev)
    _build.require("observed", observed, torch.bool, (E, S, T), dev)
    _build.require("init_value", init_value, torch.float32, (E, S), dev)
    _build.require("init_has", init_has, torch.bool, (E, S), dev)
    R = E * S
    if dev.type == "cpu":
        out, has = locf_ref(values.reshape(R, T), observed.reshape(R, T),
                            init_value.reshape(R), init_has.reshape(R))
        return out.reshape(E, S, T), has.reshape(E, S, T)
    if dev.type != "cuda":
        raise ValueError(f"locf: no kernel for device {dev}")
    lib = _build.library()
    out = torch.empty_like(values)
    has = torch.empty_like(observed)
    _build.check(lib.locf_launch(
        values.data_ptr(), observed.data_ptr(), init_value.data_ptr(),
        init_has.data_ptr(), out.data_ptr(), has.data_ptr(), R, T,
        _build.stream_ptr(dev)), "locf")
    LAUNCHES += 1
    return out, has
