"""Wrapper of the harmonize kernel (``csrc/harmonize.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts kernel launches. Like the
reference's op entry point, this is not wired into the pipeline tick, which
harmonizes through ``core.harmonize.harmonize_segment``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.harmonize.ref import harmonize_ref

LAUNCHES = 0


def harmonize(values, timestamps, valid, window_start, *, tick_s: float,
              n_ticks: int):
    """Batched entry: (E, S, M) raw samples -> (E, S, T) tick means.

    values/timestamps float32, valid bool, window_start (E,) float32.
    Returns (values (E, S, T) float32, observed (E, S, T) bool).
    """
    global LAUNCHES
    E, S, M = values.shape
    dev = values.device
    _build.require("values", values, torch.float32, (E, S, M), dev)
    _build.require("timestamps", timestamps, torch.float32, (E, S, M), dev)
    _build.require("valid", valid, torch.bool, (E, S, M), dev)
    _build.require("window_start", window_start, torch.float32, (E,), dev)
    if n_ticks < 1 or not tick_s > 0:
        raise ValueError("harmonize: need n_ticks >= 1 and tick_s > 0")
    R = E * S
    if dev.type == "cpu":
        t0 = window_start[:, None].expand(E, S).reshape(R)
        out, obs = harmonize_ref(values.reshape(R, M),
                                 timestamps.reshape(R, M),
                                 valid.reshape(R, M), t0, tick_s, n_ticks)
        return out.reshape(E, S, n_ticks), obs.reshape(E, S, n_ticks)
    if dev.type != "cuda":
        raise ValueError(f"harmonize: no kernel for device {dev}")
    lib = _build.library()
    out = torch.empty((E, S, n_ticks), dtype=torch.float32, device=dev)
    obs = torch.empty((E, S, n_ticks), dtype=torch.bool, device=dev)
    _build.check(lib.harmonize_launch(
        values.data_ptr(), timestamps.data_ptr(), valid.data_ptr(),
        window_start.data_ptr(), out.data_ptr(), obs.data_ptr(), E, S, M,
        n_ticks, float(tick_s), _build.stream_ptr(dev)), "harmonize")
    LAUNCHES += 1
    return out, obs
