"""Wrapper of the window_agg kernel (``csrc/window_agg.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
one of the kernel's two instances, chosen by :func:`impl_for` (``"row"``
for T <= 16, ``"warp"`` above; see ``kernels/rows.py``), or raises.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_IMPL`` the same per
instance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rows import IMPLS, aligned, impl_for
from repro_torch.kernels.window_agg.ref import N_STATS, window_agg_ref

LAUNCHES = 0
LAUNCHES_BY_IMPL = {"row": 0, "warp": 0}


def window_agg(values, mask, state_mean, state_var, *,
               k_sigma: float = 6.0):
    """Batched entry: values/mask (E, S, T); state (E, S). Values and
    state of any dtype are read as float32 and the mask as ``> 0`` after a
    float32 cast, as the reference's entry reads them. Returns (stats
    (E, S, N_STATS) float32, spikes (E, S, T) bool)."""
    global LAUNCHES
    values, state_mean, state_var = map(_build.as_float32,
                                        (values, state_mean, state_var))
    mask = _build.as_mask(mask)
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
    if T < 1:
        raise ValueError("window_agg: needs at least one tick")
    if R * max(T, N_STATS) >= 2 ** 31:
        raise ValueError(f"window_agg: {R} rows x {max(T, N_STATS)}; the "
                         "kernel indexes in 32 bits (< 2^31)")
    lib = _build.library()
    stats = torch.empty((E, S, N_STATS), dtype=torch.float32, device=dev)
    spikes = torch.empty_like(mask)
    impl, vec = impl_for(T, aligned(values, mask, stats, spikes))
    with _build.on_device(dev):
        _build.check(lib.window_agg_launch(
            values.data_ptr(), mask.data_ptr(), state_mean.data_ptr(),
            state_var.data_ptr(), stats.data_ptr(), spikes.data_ptr(), R, T,
            float(k_sigma), IMPLS[impl], int(vec), _build.stream_ptr(dev)),
            f"window_agg ({impl})")
    LAUNCHES += 1
    LAUNCHES_BY_IMPL[impl] += 1
    return stats, spikes
