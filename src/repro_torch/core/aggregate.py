"""Window aggregation + cross-stream relationships — port of
``repro.core.aggregate``.

``combine`` maps harmonized per-tick streams to derived features through a
(features x streams) weight matrix (weighted averages across same-area
sensors, sums across feeders). Contractions are written as multiply + sum,
so their rounding never depends on a matrix library's choice of kernel.
"""
from __future__ import annotations

import torch

AGGS = ("last", "mean", "sum", "min", "max", "std", "count")

# kernels/window_agg stats-column layout:
# [mean, var, min, max, last, count, sum, n_spikes]
_KERNEL_COLS = {"mean": 0, "min": 2, "max": 3, "last": 4, "count": 5,
                "sum": 6}
BIG = 3.4e38


def window_agg(values, mask, agg: str, *, use_kernel: bool = False):
    """Aggregate the tick dim away. values/mask: (E, S, T) -> (E, S).

    ``use_kernel=True`` computes every aggregate from one launch of the
    fused ``kernels/window_agg`` op (all eight window stats in one pass)
    instead of a per-agg reduction; empty windows are fixed up to this
    module's conventions (min/max saturate, the rest are 0).
    """
    if use_kernel and (agg == "std" or agg in _KERNEL_COLS):
        from repro_torch.kernels.window_agg.ops import window_agg as kernel
        zeros = torch.zeros(values.shape[:2], dtype=torch.float32,
                            device=values.device)
        stats, _ = kernel(values.contiguous(), mask.contiguous(), zeros,
                          zeros + 1.0)
        if agg == "std":
            return stats[..., 1].sqrt()
        out = stats[..., _KERNEL_COLS[agg]]
        # the kernel zeroes empty-window min/max; this module saturates.
        # Its count column is exact, so it says which windows are empty
        n = stats[..., _KERNEL_COLS["count"]]
        if agg == "min":
            return torch.where(n > 0, out, BIG)
        if agg == "max":
            return torch.where(n > 0, out, -BIG)
        return out
    w = mask.to(torch.float32)
    n = w.sum(-1)
    if agg == "last":
        T = values.shape[-1]
        idx = torch.where(mask, torch.arange(T, device=values.device), -1)
        idx = idx.amax(-1)
        take = values.gather(-1, idx.clamp(min=0)[..., None])[..., 0]
        return torch.where(idx >= 0, take, 0.0)
    if agg == "mean":
        return (values * w).sum(-1) / n.clamp(min=1)
    if agg == "sum":
        return (values * w).sum(-1)
    if agg == "min":
        return torch.where(mask, values, BIG).amin(-1)
    if agg == "max":
        return torch.where(mask, values, -BIG).amax(-1)
    if agg == "std":
        m = (values * w).sum(-1) / n.clamp(min=1)
        d = values - m[..., None]
        return ((d * d * w).sum(-1) / n.clamp(min=1)).sqrt()
    if agg == "count":
        return n
    raise ValueError(agg)


def combine(values, weights):
    """Cross-stream relationships. values (E,S,T) x weights (F,S) -> (E,F,T)."""
    return (values[:, None, :, :] * weights[None, :, :, None]).sum(2)


def feature_vector(values, mask, weights, *, per_tick: bool = False,
                   feature_agg: str = "last", use_kernel: bool = False):
    """Full Manager output: derived features flattened for the Encoder.

    values/mask (E,S,T), weights (F,S) ->
      per_tick=False: (E, F) — the value at the final tick when
        ``feature_agg="last"``, else each stream's window aggregate
        (:func:`window_agg`, through the kernel when ``use_kernel``)
        combined through ``weights``
      per_tick=True : (E, F*T) the whole harmonized window
    """
    if per_tick:
        feats = combine(values, weights)                 # (E, F, T)
        return feats.reshape(feats.shape[0], -1)
    if feature_agg != "last":
        per_stream = window_agg(values, mask, feature_agg,
                                use_kernel=use_kernel)   # (E, S)
        return (per_stream[:, None, :] * weights[None]).sum(-1)
    return combine(values, weights)[..., -1]
