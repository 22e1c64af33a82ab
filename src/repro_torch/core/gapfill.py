"""Gap filling — port of ``repro.core.gapfill``.

Strategies (a single string, or an (S,) int vector indexing STRATEGIES):
  locf      last observation carried forward (across windows through the
            carried ``last_value`` state)
  linear    bridge interior gaps linearly between observations (falls back
            to locf at the trailing edge)
  ewma      exponentially-weighted mean of past observations
  seasonal  mean of the same tick-of-day from history

``use_kernel=True`` routes the string ``"locf"`` strategy through the
``kernels/locf`` op (the CUDA kernel on the card, its plain version on the
CPU). The kernel is pure selection, so its fill values equal this module's
wherever the ``has`` mask is True, the only place ``gap_fill`` reads them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

STRATEGIES = ("locf", "linear", "ewma", "seasonal")


class GapFillState(NamedTuple):
    last_value: torch.Tensor   # (E, S) last observed value ever
    last_ts: torch.Tensor      # (E, S)
    ewma: torch.Tensor         # (E, S)
    seasonal: torch.Tensor     # (E, S, K) per time-of-day slot running mean
    seasonal_n: torch.Tensor   # (E, S, K)


def init_state(E, S, K=24, device="cpu") -> GapFillState:
    z = torch.zeros((E, S), dtype=torch.float32, device=device)
    zk = torch.zeros((E, S, K), dtype=torch.float32, device=device)
    return GapFillState(z, z - 1e30, z.clone(), zk, zk.clone())


# The reference switches from its dense O(T^2) form to an associative scan
# above this many ticks; the two return different values where no
# observation exists yet (see _locf_scan), so the port keeps the switch.
_DENSE_T_MAX = 64


def _locf_scan(values, observed, init_value, init_has):
    """Carry (value, has) of the latest observation along the tick axis.

    Positions with no observation at or before them return (0, False) on
    the dense branch and (init_value, False) on the scan branch, as in the
    reference — callers mask by ``has``.
    """
    v = torch.cat([init_value[..., None].to(torch.float32), values], dim=-1)
    o = torch.cat([init_has[..., None], observed], dim=-1)
    j = torch.arange(v.shape[-1], device=v.device)
    latest = torch.where(o, j, -1).cummax(dim=-1).values
    cv = v.gather(-1, latest.clamp(min=0))
    has = latest >= 0
    if v.shape[-1] <= _DENSE_T_MAX:
        cv = torch.where(has, cv, 0.0)
    return cv[..., 1:], has[..., 1:]


def locf(values, observed, state: GapFillState):
    has_prev = state.last_ts > -1e29
    return _locf_scan(values, observed, state.last_value, has_prev)


def linear_bridge(values, observed):
    """Interior gaps -> linear interp between neighbours (edges untouched)."""
    T = values.shape[-1]
    lead = values.shape[:-1]
    idx = torch.arange(T, dtype=torch.float32, device=values.device)
    idx_b = idx.expand(values.shape)
    zeros = torch.zeros(lead, dtype=torch.float32, device=values.device)
    nones = torch.zeros(lead, dtype=torch.bool, device=values.device)
    # distance to previous / next observation via two locf passes each way
    fwd_v, fwd_has = _locf_scan(values, observed, zeros, nones)
    fwd_i, _ = _locf_scan(idx_b, observed, zeros - 1.0, nones)
    rev = lambda x: torch.flip(x, dims=(-1,))
    bwd_v, bwd_has = _locf_scan(rev(values), rev(observed), zeros, nones)
    bwd_i, _ = _locf_scan(idx_b, rev(observed), zeros - 1.0, nones)
    bwd_v, bwd_has, bwd_i = rev(bwd_v), rev(bwd_has), (T - 1) - rev(bwd_i)
    span = (bwd_i - fwd_i).clamp(min=1e-6)
    frac = ((idx - fwd_i) / span).clamp(0.0, 1.0)
    interior = fwd_has & bwd_has
    interp = fwd_v + frac * (bwd_v - fwd_v)
    out = torch.where(observed, values,
                      torch.where(interior, interp, fwd_v))
    return out, interior | fwd_has


def gap_fill(values, observed, state: GapFillState, tick_ts, strategy, *,
             tick_of_day=None, ewma_alpha: float = 0.2,
             use_kernel: bool = False):
    """Fill unobserved ticks. strategy: (S,) int index into STRATEGIES or a
    single string. Returns (filled_values, filled_mask, new_state).

    ``use_kernel`` only affects the string ``"locf"`` strategy."""
    E, S, T = values.shape
    dev = values.device
    if tick_of_day is None:
        tick_of_day = torch.zeros((E, T), dtype=torch.int32, device=dev)

    # a string strategy only pays for the branch it selects
    def _locf():
        if use_kernel and isinstance(strategy, str) and strategy == "locf":
            from repro_torch.kernels.locf.ops import locf as locf_kernel
            return locf_kernel(values.contiguous(), observed.contiguous(),
                               state.last_value.contiguous(),
                               (state.last_ts > -1e29).contiguous())
        return locf(values, observed, state)

    def _linear():
        locf_v, locf_has = _locf()
        lin_v, lin_has = linear_bridge(values, observed)
        lin_v = torch.where(observed | lin_has, lin_v, locf_v)
        return lin_v, lin_has | locf_has

    def _ewma():
        ew_v = torch.where(observed, values, state.ewma[..., None])
        ew_has = (state.last_ts[..., None] > -1e29).expand(values.shape)
        return ew_v, ew_has

    def _seasonal():
        K = state.seasonal.shape[-1]
        slot = (tick_of_day[:, None, :] % K).to(torch.int64).expand(E, S, T)
        sea = state.seasonal.gather(-1, slot)
        sea_n = state.seasonal_n.gather(-1, slot)
        return torch.where(observed, values, sea), sea_n > 0

    branches = {"locf": _locf, "linear": _linear, "ewma": _ewma,
                "seasonal": _seasonal}
    if isinstance(strategy, str):
        out_v, out_h = branches[strategy]()
    else:
        outs = [branches[s]() for s in STRATEGIES]
        stack_v = torch.stack([o[0] for o in outs])
        stack_h = torch.stack([o[1] for o in outs])
        sel = torch.as_tensor(strategy, dtype=torch.int64, device=dev)
        sel = sel[None, None, :, None].expand(1, E, S, T)
        out_v = stack_v.gather(0, sel)[0]
        out_h = stack_h.gather(0, sel)[0]

    filled = (~observed) & out_h
    out = torch.where(observed, values, torch.where(filled, out_v, 0.0))

    # ---- state update (from OBSERVED ticks only) ---------------------------
    w = observed.to(torch.float32)
    any_obs = observed.any(-1)
    big = 3.4e38
    ts_b = tick_ts[:, None, :].expand(values.shape)
    last_key = torch.where(observed, ts_b, -big)
    is_last = (last_key == last_key.amax(-1, keepdim=True)) & observed
    new_last = (values * is_last.to(torch.float32)).sum(-1) / \
        is_last.sum(-1).clamp(min=1)
    new_last_ts = torch.where(observed, ts_b, -1e30).amax(-1)
    obs_mean = (values * w).sum(-1) / observed.sum(-1).clamp(min=1)
    sea_mean, sea_n = _seasonal_update(state, values, observed, tick_of_day)
    new_state = GapFillState(
        last_value=torch.where(any_obs, new_last, state.last_value),
        last_ts=torch.maximum(state.last_ts, new_last_ts),
        ewma=torch.where(any_obs,
                         (1 - ewma_alpha) * state.ewma
                         + ewma_alpha * obs_mean,
                         state.ewma),
        seasonal=sea_mean,
        seasonal_n=sea_n,
    )
    return out, filled, new_state


def _seasonal_update(state, values, observed, tick_of_day):
    K = state.seasonal.shape[-1]
    oh = torch.nn.functional.one_hot((tick_of_day % K).to(torch.int64), K)
    w = oh.to(torch.float32)[:, None] * observed[..., None]     # (E,S,T,K)
    s = (values[..., None] * w).sum(2)
    n = w.sum(2)
    total_n = state.seasonal_n + n
    mean = torch.where(total_n > 0,
                       (state.seasonal * state.seasonal_n + s)
                       / total_n.clamp(min=1),
                       state.seasonal)
    return mean, total_n
