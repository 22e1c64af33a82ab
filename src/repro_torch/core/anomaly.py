"""Anomaly handling — port of ``repro.core.anomaly``.

Detection: z-score against carried running statistics (an exponential
Welford over clean observed ticks). Replacement: clip to the k-sigma
envelope, substitute the running mean, or mark as missing so gap-filling
handles the tick. ``detect_mad`` is not ported yet (``torch.nanmedian``
takes the lower middle value where ``jnp.nanmedian`` averages the two).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

POLICIES = ("clip", "mean", "missing")


class AnomalyState(NamedTuple):
    mean: torch.Tensor    # (E, S) running mean
    var: torch.Tensor     # (E, S) running variance
    count: torch.Tensor   # (E, S)


def init_state(E, S, device="cpu") -> AnomalyState:
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


def detect_mad(values, observed, k: float = 8.0):
    raise NotImplementedError(
        "detect_mad is not ported yet: torch.nanmedian and jnp.nanmedian "
        "disagree on even counts; see ROADMAP.md, queue 1")


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
