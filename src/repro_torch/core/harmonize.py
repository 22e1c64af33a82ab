"""Data-rate harmonization — port of ``repro.core.harmonize``.

Aligns every stream onto the model's tick grid: tick t collects the
samples with timestamp in (tick_ts[t] - tick, tick_ts[t]], several samples
per tick aggregate (mean/last/sum/min/max), ticks with no sample are
marked unobserved. Vectorized over (E, S, M) x (T,).
"""
from __future__ import annotations

import torch

from repro_torch.core.frame import RawWindow

AGGS = ("mean", "last", "sum", "min", "max")
BIG = 3.4e38

# Below this many one-hot elements per (E, S) row the dense mask
# contraction replaces the segment scatter, as in the reference (the branch
# point is part of the semantics the tests hold: both branches are ported).
_DENSE_MT_MAX = 8192


def exact_div(x, c: float):
    """``x / c`` rounded once, as IEEE division (and the reference) rounds
    it. On CUDA, PyTorch divides by a Python scalar as ``x * (1 / c)``,
    which is off by an ulp often enough to move ``ceil`` across an integer:
    180 * f32(1/60) rounds to 3.0000002, so a sample on a tick boundary
    would land a bucket late. A 0-d device tensor divides exactly."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def tick_grid(window_start, tick_s: float, n_ticks: int):
    """Tick timestamps (end-of-bucket convention). window_start: (E,)."""
    steps = 1.0 + torch.arange(n_ticks, dtype=torch.float32,
                               device=window_start.device)
    return window_start[:, None] + tick_s * steps


def bucketize(raw: RawWindow, tick_ts, tick_s: float):
    """Bucket index per raw sample. Returns (idx (E,S,M), in_range (E,S,M))."""
    t0 = tick_ts[:, 0] - tick_s  # window start
    rel = raw.timestamps - t0[:, None, None]
    idx = torch.ceil(exact_div(rel, tick_s)).to(torch.int32) - 1
    T = tick_ts.shape[1]
    ok = raw.valid & (idx >= 0) & (idx < T)
    return idx.clamp(0, T - 1), ok


def _harmonize_dense(values, timestamps, idx, ok, T: int, agg: str):
    """One-hot-mask aggregation for one requested ``agg`` (small M*T)."""
    ticks = torch.arange(T, dtype=torch.int32, device=values.device)
    if agg in ("mean", "sum"):
        w = ((idx[..., None] == ticks) & ok[..., None]).to(torch.float32)
        count = w.sum(2)                                         # (E,S,T)
        observed = count > 0
        total = (values[..., None] * w).sum(2)
        out = total if agg == "sum" else total / count.clamp(min=1.0)
        return torch.where(observed, out, 0.0), observed

    onehot = (idx[:, :, None, :] == ticks[:, None]) & ok[:, :, None, :]
    count = onehot.to(torch.float32).sum(-1)                     # (E,S,T)
    observed = count > 0
    v_tm = values[:, :, None, :]
    if agg == "min":
        out = torch.where(onehot, v_tm, BIG).amin(-1)
    elif agg == "max":
        out = torch.where(onehot, v_tm, -BIG).amax(-1)
    elif agg == "last":
        ts_key = torch.where(onehot, timestamps[:, :, None, :], -BIG)
        last_sel = (ts_key == ts_key.amax(-1, keepdim=True)) & onehot
        sel = last_sel.to(torch.float32)
        out = (v_tm * sel).sum(-1) / sel.sum(-1).clamp(min=1.0)
    else:
        raise ValueError(agg)
    return torch.where(observed, out, 0.0), observed


def _segment(src, seg, n_seg, reduce: str, init: float):
    out = torch.full((n_seg,), init, dtype=src.dtype, device=src.device)
    if reduce == "sum":
        return out.index_add_(0, seg, src)
    return out.scatter_reduce_(0, seg, src, reduce=reduce, include_self=True)


def harmonize_segment(raw: RawWindow, tick_ts, tick_s: float,
                      agg: str = "mean"):
    """Segment-reduction harmonization: O(M) per sample. Small windows
    (M*T <= ``_DENSE_MT_MAX``) take the dense mask form instead.

    The scatter branch adds with atomics on CUDA, in an order that changes
    from run to run; only the dense branch is bit-reproducible there."""
    E, S, M = raw.values.shape
    T = tick_ts.shape[1]
    idx, ok = bucketize(raw, tick_ts, tick_s)
    if M * T <= _DENSE_MT_MAX:
        return _harmonize_dense(raw.values, raw.timestamps, idx, ok, T, agg)
    dev = raw.values.device
    rows = torch.arange(E * S, device=dev).reshape(E, S, 1)
    seg = torch.where(ok, rows * T + idx, E * S * T).reshape(-1)
    n_seg = E * S * T + 1
    v = torch.where(ok, raw.values, 0.0).reshape(-1)
    okf = ok.to(torch.float32).reshape(-1)

    count = _segment(okf, seg, n_seg, "sum", 0.0)[:-1]
    observed = (count > 0).reshape(E, S, T)
    if agg in ("mean", "sum"):
        total = _segment(v, seg, n_seg, "sum", 0.0)[:-1]
        out = total if agg == "sum" else total / count.clamp(min=1.0)
    elif agg == "min":
        out = _segment(torch.where(ok, raw.values, BIG).reshape(-1), seg,
                       n_seg, "amin", float("inf"))[:-1]
    elif agg == "max":
        out = _segment(torch.where(ok, raw.values, -BIG).reshape(-1), seg,
                       n_seg, "amax", float("-inf"))[:-1]
    elif agg == "last":
        ts = torch.where(ok, raw.timestamps, -BIG).reshape(-1)
        bucket_last = _segment(ts, seg, n_seg, "amax", float("-inf"))
        is_last = ((ts == bucket_last[seg]) & (okf > 0)).to(torch.float32)
        den = _segment(is_last, seg, n_seg, "sum", 0.0)[:-1]
        num = _segment(v * is_last, seg, n_seg, "sum", 0.0)[:-1]
        out = num / den.clamp(min=1.0)
    else:
        raise ValueError(agg)
    out = out.reshape(E, S, T)
    return torch.where(observed, out, 0.0), observed


def harmonize(raw: RawWindow, tick_ts, tick_s: float, agg: str = "mean",
              stream_agg=None):
    """Align raw samples to the tick grid (one-hot contraction form).

    raw: (E, S, M); tick_ts: (E, T). agg: default aggregation; stream_agg:
    optional (S,) int selecting AGGS per stream (heterogeneous sources).
    Returns (values (E,S,T), observed (E,S,T)).
    """
    T = tick_ts.shape[1]
    idx, ok = bucketize(raw, tick_ts, tick_s)
    ticks = torch.arange(T, dtype=torch.int32, device=idx.device)
    onehot = (idx[..., None] == ticks) & ok[..., None]           # (E,S,M,T)
    w = onehot.to(torch.float32)
    count = w.sum(2)                                             # (E,S,T)
    observed = count > 0

    v = raw.values[..., None]
    sum_v = (v * w).sum(2)
    mean_v = sum_v / count.clamp(min=1.0)
    min_v = torch.where(onehot, v, BIG).amin(2)
    max_v = torch.where(onehot, v, -BIG).amax(2)
    # last = sample with max timestamp within the bucket
    ts_key = torch.where(onehot, raw.timestamps[..., None], -BIG)
    last_sel = ((ts_key == ts_key.amax(2, keepdim=True)) & onehot)
    last_v = (v * last_sel.to(torch.float32)).sum(2) / \
        last_sel.sum(2).clamp(min=1)

    stack = torch.stack([mean_v, last_v, sum_v, min_v, max_v])  # (5,E,S,T)
    if stream_agg is None:
        out = stack[AGGS.index(agg)]
    else:
        sel = torch.as_tensor(stream_agg, dtype=torch.int64,
                              device=stack.device)
        out = stack.gather(0, sel[None, None, :, None].expand(
            (1,) + stack.shape[1:]))[0]
    return torch.where(observed, out, 0.0), observed


def harmonize_interp(raw: RawWindow, tick_ts, *, max_gap_s: float = 0.0,
                     prev_value=None, prev_ts=None):
    """Linear interpolation between bracketing samples: not ported yet."""
    raise NotImplementedError(
        "harmonize_interp (PipelineConfig.interp_streams) is not ported yet; "
        "see ROADMAP.md, queue 1")
