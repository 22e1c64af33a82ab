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
    """Segment ``amin``/``amax``: exact whatever order the card's atomics
    take. Sums go through :func:`_tick_sums` instead."""
    out = torch.full((n_seg,), init, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, seg, src, reduce=reduce, include_self=True)


def _tick_sums(idx, ok, T: int, *cols):
    """Per-tick sums over M of each (E, S, M) column of ``cols`` (and the
    hit count first), in a fixed order on every device. A stable sort of
    each row's samples by tick (out-of-range samples last) puts a tick's
    samples side by side in M order; a segmented inclusive scan of
    ``ceil(log2 M)`` fixed steps adds within runs of equal ticks only, so a
    non-finite value leaves the other ticks alone; the last sample of each
    run holds its tick's sum and is the only one to write that tick. The
    work is O(M log M) a row whatever T. ``index_add_`` would add with
    atomics on CUDA, in an order that changes from run to run."""
    M = idx.shape[-1]
    key, perm = torch.where(ok, idx, T).sort(dim=-1, stable=True)
    x = torch.stack((ok.to(torch.float32),) + cols)           # (C, E, S, M)
    x = x.gather(-1, perm.expand_as(x))
    d = 1
    while d < M:
        same = key[..., d:] == key[..., :-d]
        x = torch.cat((x[..., :d], torch.where(same, x[..., d:] + x[..., :-d],
                                                x[..., d:])), -1)
        d *= 2
    # each run's last sample writes its tick; the rest go to column T
    end = torch.cat((key[..., 1:] != key[..., :-1],
                     torch.ones_like(key[..., :1], dtype=torch.bool)), -1)
    dst = torch.where(end, key, T).expand_as(x)
    out = x.new_zeros(x.shape[:-1] + (T + 1,)).scatter_(-1, dst, x)
    return list(out[..., :T])


def harmonize_segment(raw: RawWindow, tick_ts, tick_s: float,
                      agg: str = "mean"):
    """Segment-reduction harmonization. Small windows (M*T <=
    ``_DENSE_MT_MAX``) take the dense mask form; larger ones sum each tick
    through :func:`_tick_sums` (a fixed order on every device, so two calls
    and ``run_many`` against K ticks agree bit for bit on the card too) and
    take ``amin``/``amax`` by segment scatter, which is exact in any
    order."""
    E, S, M = raw.values.shape
    T = tick_ts.shape[1]
    idx, ok = bucketize(raw, tick_ts, tick_s)
    if M * T <= _DENSE_MT_MAX:
        return _harmonize_dense(raw.values, raw.timestamps, idx, ok, T, agg)
    v = torch.where(ok, raw.values, 0.0)
    if agg in ("mean", "sum"):
        count, total = _tick_sums(idx, ok, T, v)
        out = total if agg == "sum" else total / count.clamp(min=1.0)
    elif agg in ("min", "max", "last"):
        dev = raw.values.device
        rows = torch.arange(E * S, device=dev).reshape(E, S, 1)
        seg = torch.where(ok, rows * T + idx, E * S * T).reshape(-1)
        n_seg = E * S * T + 1
        if agg == "last":
            ts = torch.where(ok, raw.timestamps, -BIG).reshape(-1)
            bucket_last = _segment(ts, seg, n_seg, "amax", float("-inf"))
            is_last = ((ts == bucket_last[seg]) & ok.reshape(-1)) \
                .to(torch.float32).reshape(E, S, M)
            count, den, num = _tick_sums(idx, ok, T, is_last, v * is_last)
            out = num / den.clamp(min=1.0)
        else:
            (count,) = _tick_sums(idx, ok, T)
            fill, init = (BIG, "inf") if agg == "min" else (-BIG, "-inf")
            out = _segment(torch.where(ok, raw.values, fill).reshape(-1),
                           seg, n_seg, "a" + agg, float(init))[:-1] \
                .reshape(E, S, T)
    else:
        raise ValueError(agg)
    observed = count > 0
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
    """Linear interpolation of each tick between its bracketing samples.

    For slow sources (the paper's once-an-hour devices) bucketing leaves
    most ticks empty; interpolation rebuilds the tick resolution instead.
    O(M*T) masked max/min, no sort. ``prev_value``/``prev_ts`` (E, S) carry
    the last sample of the previous window in, so the first ticks bridge
    the window boundary; ``max_gap_s > 0`` interpolates only across gaps
    that short (a longer gap holds the earlier sample).

    Each selected-sample sum is multiply + sum over M, as the reference's
    einsum: a 0 weight times an inf or NaN value gives NaN, as in XLA's
    dot. Every division is by a tensor (see :func:`exact_div`)."""
    ts = torch.where(raw.valid, raw.timestamps, float("inf"))    # (E,S,M)
    tsn = torch.where(raw.valid, raw.timestamps, float("-inf"))
    tick = tick_ts[:, None, :, None]                             # (E,1,T,1)
    tsn_m, ts_m = tsn[:, :, None, :], ts[:, :, None, :]          # (E,S,1,M)
    before = tsn_m <= tick                                       # (E,S,T,M)
    after = ts_m > tick

    t_lo = torch.where(before, tsn_m, -BIG).amax(-1)             # (E,S,T)
    t_hi = torch.where(after, ts_m, BIG).amin(-1)
    sel_lo = before & (tsn_m == t_lo[..., None])
    sel_hi = after & (ts_m == t_hi[..., None])
    den_lo = sel_lo.sum(-1).clamp(min=1)
    den_hi = sel_hi.sum(-1).clamp(min=1)
    vals = raw.values[:, :, None, :]
    v_lo = (sel_lo.to(torch.float32) * vals).sum(-1) / den_lo
    v_hi = (sel_hi.to(torch.float32) * vals).sum(-1) / den_hi
    has_lo = t_lo > -BIG
    has_hi = t_hi < BIG

    if prev_value is not None and prev_ts is not None:
        bridge = ~has_lo & (prev_ts[:, :, None] <= tick_ts[:, None, :])
        t_lo = torch.where(bridge, prev_ts[:, :, None], t_lo)
        v_lo = torch.where(bridge, prev_value[:, :, None], v_lo)
        has_lo = has_lo | bridge

    span = (t_hi - t_lo).clamp(min=1e-6)
    frac = ((tick_ts[:, None, :] - t_lo) / span).clamp(0.0, 1.0)
    both = has_lo & has_hi
    if max_gap_s > 0:
        both = both & ((t_hi - t_lo) <= max_gap_s)
    interp = v_lo + frac * (v_hi - v_lo)
    out = torch.where(both, interp, torch.where(has_lo, v_lo, 0.0))
    return out, both | has_lo
