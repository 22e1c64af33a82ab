"""Streaming normalization — port of ``repro.core.normalize``.

Running per-(env, stream) statistics with a Chan/Welford merge of each
window's batch statistics; z-score or min-max normalization and their
exact inverses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class NormState(NamedTuple):
    count: torch.Tensor  # (E, S)
    mean: torch.Tensor
    m2: torch.Tensor     # sum of squared deviations
    min: torch.Tensor
    max: torch.Tensor


def init_state(E, S, device=None) -> NormState:
    device = resolve_device(device)
    z = torch.zeros((E, S), dtype=torch.float32, device=device)
    inf = torch.full((E, S), float("inf"), dtype=torch.float32,
                     device=device)
    return NormState(z, z.clone(), z.clone(), inf, -inf)


def update(state: NormState, values, observed) -> NormState:
    """Chan/Welford parallel merge of this window's stats into the running
    stats — one vectorized step per window."""
    w = observed.to(torch.float32)
    nb = w.sum(-1)
    mb = (values * w).sum(-1) / nb.clamp(min=1)
    d = values - mb[..., None]
    m2b = (d * d * w).sum(-1)
    na = state.count
    n = na + nb
    n1 = n.clamp(min=1)
    delta = mb - state.mean
    mean = torch.where(n > 0, state.mean + delta * nb / n1, state.mean)
    m2 = state.m2 + m2b + delta * delta * na * nb / n1
    big = 3.4e38
    vmin = torch.minimum(state.min,
                         torch.where(observed, values, big).amin(-1))
    vmax = torch.maximum(state.max,
                         torch.where(observed, values, -big).amax(-1))
    has = nb > 0
    return NormState(
        count=n,
        mean=mean,
        m2=torch.where(has, m2, state.m2),
        min=torch.where(has, vmin, state.min),
        max=torch.where(has, vmax, state.max),
    )


def _ex(state_leaf, x):
    return state_leaf.reshape(state_leaf.shape + (1,) * (x.dim() - 2))


def sigma(state: NormState):
    return (state.m2 / (state.count - 1).clamp(min=1)).clamp(
        min=1e-12).sqrt()


def znorm(state: NormState, values):
    """values (E, S, ...) -> z-scores using running stats."""
    return (values - _ex(state.mean, values)) / \
        _ex(sigma(state), values).clamp(min=1e-6)


def denorm_z(state: NormState, z):
    return z * _ex(sigma(state), z).clamp(min=1e-6) + _ex(state.mean, z)


def minmax(state: NormState, values):
    span = (_ex(state.max, values) - _ex(state.min, values)).clamp(min=1e-6)
    return ((values - _ex(state.min, values)) / span).clamp(0.0, 1.0)


def denorm_minmax(state: NormState, u):
    span = (_ex(state.max, u) - _ex(state.min, u)).clamp(min=1e-6)
    return u * span + _ex(state.min, u)
