"""Plain PyTorch version of the fused window-stats + spike-mask kernel
(twin of ``window_agg_ref``)."""
from __future__ import annotations

import torch

N_STATS = 8  # mean, var, min, max, last, count, sum, n_spikes


def window_agg_ref(values, mask, state_mean, state_var, k_sigma: float):
    """values/mask: (R, T) float32/bool rows; state_mean/var: (R,).

    Returns (stats (R, N_STATS) float32, spikes (R, T) bool): stats columns
    are [mean, var, min, max, last, count, sum, n_spikes] over masked ticks
    (min/max/last are 0 for an empty row); spikes are z-score outliers
    against the carried running stats.
    """
    w = mask.to(torch.float32)
    n = w.sum(-1)
    s = (values * w).sum(-1)
    mean = s / n.clamp(min=1.0)
    d = values - mean[:, None]
    var = (d * d * w).sum(-1) / n.clamp(min=1.0)
    big = 3.4e38
    vmin = torch.where(mask, values, big).amin(-1)
    vmax = torch.where(mask, values, -big).amax(-1)
    T = values.shape[-1]
    idx = torch.where(mask, torch.arange(T, device=values.device), -1)
    idx = idx.amax(-1)
    last = values.gather(1, idx.clamp(min=0)[:, None])[:, 0]
    last = torch.where(idx >= 0, last, 0.0)
    vmin = torch.where(n > 0, vmin, 0.0)
    vmax = torch.where(n > 0, vmax, 0.0)

    sigma = state_var.clamp(min=1e-12).sqrt()
    z = (values - state_mean[:, None]).abs() / sigma[:, None]
    spikes = mask & (z > k_sigma)
    stats = torch.stack([mean, var, vmin, vmax, last, n, s,
                         spikes.sum(-1).to(torch.float32)], dim=-1)
    return stats, spikes
