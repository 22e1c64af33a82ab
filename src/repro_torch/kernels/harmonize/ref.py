"""Plain PyTorch version of the harmonize kernel (twin of
``repro.kernels.harmonize.ref.harmonize_ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.harmonize import exact_div


def harmonize_ref(values, timestamps, valid, t0, tick_s: float,
                  n_ticks: int):
    """Rows of raw samples -> tick means.

    values/timestamps (R, M) float32, valid (R, M) bool, t0 (R,) window
    starts. Bucket ``ceil((ts - t0) / tick_s) - 1``; the mean of the valid,
    in-range samples of each tick, with the hit weight multiplied into the
    value (a NaN in a sample that misses still propagates, as in the
    kernel). Returns (out (R, T) float32, observed (R, T) bool).
    """
    rel = exact_div(timestamps - t0[:, None], tick_s)   # as the kernel
    idx = torch.ceil(rel).to(torch.int32) - 1
    ok = valid & (idx >= 0) & (idx < n_ticks)
    ticks = torch.arange(n_ticks, dtype=torch.int32, device=values.device)
    onehot = ((idx[:, :, None] == ticks) & ok[:, :, None]).to(torch.float32)
    count = onehot.sum(1)                                      # (R, T)
    total = (values[:, :, None] * onehot).sum(1)
    observed = count > 0
    return torch.where(observed, total / count.clamp(min=1.0), 0.0), observed
