"""Wrapper of the window_agg kernel (``csrc/window_agg.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_agg.ref import N_STATS, window_agg_ref

LAUNCHES = 0


def window_agg(values, mask, state_mean, state_var, *,
               k_sigma: float = 6.0):
    """Batched entry: values/mask (E, S, T) float32/bool; state (E, S)
    float32. Returns (stats (E, S, N_STATS), spikes (E, S, T))."""
    global LAUNCHES
    E, S, T = values.shape
    dev = values.device
    _build.require("values", values, torch.float32, (E, S, T), dev)
    _build.require("mask", mask, torch.bool, (E, S, T), dev)
    _build.require("state_mean", state_mean, torch.float32, (E, S), dev)
    _build.require("state_var", state_var, torch.float32, (E, S), dev)
    R = E * S
    if dev.type == "cpu":
        stats, spikes = window_agg_ref(
            values.reshape(R, T), mask.reshape(R, T), state_mean.reshape(R),
            state_var.reshape(R), k_sigma)
        return stats.reshape(E, S, N_STATS), spikes.reshape(E, S, T)
    if dev.type != "cuda":
        raise ValueError(f"window_agg: no kernel for device {dev}")
    lib = _build.library()
    stats = torch.empty((E, S, N_STATS), dtype=torch.float32, device=dev)
    spikes = torch.empty_like(mask)
    _build.check(lib.window_agg_launch(
        values.data_ptr(), mask.data_ptr(), state_mean.data_ptr(),
        state_var.data_ptr(), stats.data_ptr(), spikes.data_ptr(), R, T,
        float(k_sigma), _build.stream_ptr(dev)), "window_agg")
    LAUNCHES += 1
    return stats, spikes
