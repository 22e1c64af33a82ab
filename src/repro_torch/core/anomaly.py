"""Anomaly handling — port of ``repro.core.anomaly``.

Detection: z-score against carried running statistics (an exponential
Welford over clean observed ticks), or the window-local median absolute
deviation (:func:`detect_mad`). Replacement: clip to the k-sigma envelope,
substitute the running mean, or mark as missing so gap-filling handles the
tick.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

POLICIES = ("clip", "mean", "missing")


class AnomalyState(NamedTuple):
    mean: torch.Tensor    # (E, S) running mean
    var: torch.Tensor     # (E, S) running variance
    count: torch.Tensor   # (E, S)


def init_state(E, S, device=None) -> AnomalyState:
    device = resolve_device(device)
    z = torch.zeros((E, S), dtype=torch.float32, device=device)
    return AnomalyState(z, torch.ones_like(z), z.clone())


def _sigma(state: AnomalyState):
    return state.var.clamp(min=1e-12).sqrt()


def detect_zscore(values, observed, state: AnomalyState,
                  k_sigma: float = 6.0):
    """Spike where |x - mean| > k * sigma (only once stats have warmed up)."""
    z = (values - state.mean[..., None]).abs() / _sigma(state)[..., None]
    warm = (state.count > 8.0)[..., None]
    return observed & warm & (z > k_sigma)


def nanmedian(x):
    """Median over the last dim ignoring NaN, as ``jnp.nanmedian`` computes
    it (JAX 0.9.0: ``nanquantile(q=0.5, method="midpoint")``, whose
    NaN-squashing branch sorts with NaN last, counts the non-NaN values n,
    takes ranks lo = floor(q) and hi = ceil(q) of q = 0.5 * (n - 1), each
    clamped to [0, n - 1], and returns ``(a[lo] + a[hi]) * 0.5``). An even
    count thus averages the two middle values, where ``torch.nanmedian``
    returns the lower one; an all-NaN row gives NaN. Keeps the last dim
    (size 1)."""
    a = x.sort(dim=-1).values                  # torch sorts NaN last
    n = (~torch.isnan(a)).sum(-1, keepdim=True, dtype=torch.int64)
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(n, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.minimum(hi, (n - 1).clamp(min=0))
    return (a.gather(-1, lo) + a.gather(-1, hi)) * 0.5


def detect_mad(values, observed, k: float = 8.0):
    """Window-local median-absolute-deviation detector (no state)."""
    big = 3.4e38
    masked = torch.where(observed, values, float("nan"))
    med = nanmedian(masked)
    mad = nanmedian((masked - med).abs())
    mad = torch.where(torch.isnan(mad) | (mad < 1e-9), big, mad)
    dev = (values - torch.where(torch.isnan(med), 0.0, med)).abs()
    return observed & (dev > k * 1.4826 * mad)


def replace(values, observed, spikes, state: AnomalyState,
            policy: str = "clip", k_sigma: float = 6.0):
    """Returns (values', observed', replaced_mask)."""
    sigma = _sigma(state)[..., None]
    mean = state.mean[..., None]
    if policy == "clip":
        clipped = torch.clamp(values, mean - k_sigma * sigma,
                              mean + k_sigma * sigma)
        return torch.where(spikes, clipped, values), observed, spikes
    if policy == "mean":
        return torch.where(spikes, mean, values), observed, spikes
    if policy == "missing":
        return torch.where(spikes, 0.0, values), observed & ~spikes, spikes
    raise ValueError(policy)


def update_state(state: AnomalyState, values, observed,
                 alpha: float = 0.05) -> AnomalyState:
    """Exponential Welford over clean observed ticks (batched over E, S)."""
    w = observed.to(torch.float32)
    n = observed.sum(-1)
    n1 = n.clamp(min=1)
    mean_w = (values * w).sum(-1) / n1
    d = values - mean_w[..., None]
    var_w = (d * d * w).sum(-1) / n1
    has = n > 0
    boot = state.count < 1
    dm = mean_w - state.mean
    new_mean = torch.where(boot, mean_w,
                           (1 - alpha) * state.mean + alpha * mean_w)
    new_var = torch.where(boot, var_w.clamp(min=1e-6),
                          (1 - alpha) * state.var
                          + alpha * (var_w + dm * dm))
    return AnomalyState(
        mean=torch.where(has, new_mean, state.mean),
        var=torch.where(has, new_var, state.var),
        count=state.count + n,
    )
