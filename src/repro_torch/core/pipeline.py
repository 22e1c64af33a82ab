"""PerceptaPipeline — the per-tick program, port of ``repro.core.pipeline``.

Modes ported here:
  * ``fused`` — one :func:`tick` per window (the reference).
  * ``scan``  — :func:`run_many`: K pre-batched windows through K ticks in
    one call, the state carried on the device between them. Outputs are
    exactly those of K sequential ticks (the same ops on the same shapes).
  * ``scan_fused_decide`` — :func:`run_many_decide`: the same K ticks with
    the Predictor's per-window decision step after each one and the K
    replay transitions banked once after the loop; the host gets only the
    small :class:`DecideBatch`.

State is one NamedTuple carried tick to tick (gap-fill memory, anomaly
stats, normalizer stats, the cross-window carry and the tick counter).

Time convention: device-visible timestamps are WINDOW-RELATIVE offsets
(the host rebases in float64 before the float32 cast and passes
``window_start = 0``). The seasonal tick-of-day slot is exact integer
arithmetic from ``state.tick_index`` and ``PipelineConfig.tick0``; the
``prev_value``/``prev_ts`` carry is stored in the frame of the window that
produced it and re-expressed one window length later each tick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.core import aggregate as agg
from repro_torch.core import anomaly as an
from repro_torch.core import gapfill as gf
from repro_torch.core import harmonize as hz
from repro_torch.core import normalize as nz
from repro_torch.core.frame import FeatureFrame, RawWindow, TickFrame
from repro_torch.device import resolve_device

# modes of the reference engine that later slices bring, by ROADMAP item
NOT_PORTED_MODES = {
    "modular": "ROADMAP.md queue 1 item 4 (the modular stage-by-stage mode)",
    "scan_sharded": "ROADMAP.md queue 1 item 12 (multi-device)",
    "scan_fused_decide_sharded": "ROADMAP.md queue 1 item 12 (multi-device)",
}
MODES = ("fused", "scan", "scan_fused_decide")


class PipelineState(NamedTuple):
    gapfill: gf.GapFillState
    anomaly: an.AnomalyState
    norm: nz.NormState
    prev_value: torch.Tensor   # (E, S) carry for cross-window interpolation
    prev_ts: torch.Tensor
    tick_index: torch.Tensor   # () int32 step counter


@dataclass(frozen=True)
class PipelineConfig:
    n_envs: int
    n_streams: int
    n_ticks: int = 16            # ticks per window
    tick_s: float = 60.0         # model time resolution
    max_samples: int = 64        # raw samples per stream per window (padded)
    agg: str = "mean"            # harmonization aggregation
    harmonize_method: str = "segment"  # segment | onehot
    interp_streams: bool = False # interpolating harmonizer (not ported yet)
    gap_strategy: str = "locf"   # locf | linear | ewma | seasonal
    anomaly_policy: str = "clip" # clip | mean | missing
    k_sigma: float = 6.0
    seasonal_slots: int = 24
    # cross-stream relationships: rows of (F, S) — defaults to identity
    combine_weights: Optional[tuple] = None
    per_tick_features: bool = False
    # "last" keeps the final tick; any other aggregate.AGGS name routes
    # through aggregate.window_agg
    feature_agg: str = "last"
    # route the locf gap-fill stage and the feature_agg window stats
    # through the kernels in repro_torch.kernels.{locf,window_agg}
    use_kernel: bool = False
    # absolute tick position of the stream origin (round(t0 / tick_s))
    tick0: int = 0

    def weights(self, device="cpu"):
        if self.combine_weights is None:
            return torch.eye(self.n_streams, dtype=torch.float32,
                             device=device)
        return torch.as_tensor(self.combine_weights, dtype=torch.float32,
                               device=device)

    @property
    def n_features(self):
        w = self.combine_weights
        n = self.n_streams if w is None else len(w)
        return n * (self.n_ticks if self.per_tick_features else 1)


def init_state(cfg: PipelineConfig, device="cpu") -> PipelineState:
    E, S = cfg.n_envs, cfg.n_streams
    return PipelineState(
        gapfill=gf.init_state(E, S, cfg.seasonal_slots, device=device),
        anomaly=an.init_state(E, S, device=device),
        norm=nz.init_state(E, S, device=device),
        prev_value=torch.zeros((E, S), dtype=torch.float32, device=device),
        prev_ts=torch.full((E, S), -1e30, dtype=torch.float32,
                           device=device),
        tick_index=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------

def stage_harmonize(cfg: PipelineConfig, state, raw: RawWindow,
                    window_start):
    ticks = hz.tick_grid(window_start, cfg.tick_s, cfg.n_ticks)
    if cfg.interp_streams:
        v, obs = hz.harmonize_interp(
            raw, ticks, prev_value=state.prev_value,
            prev_ts=state.prev_ts - cfg.n_ticks * cfg.tick_s)
    elif cfg.harmonize_method == "segment":
        v, obs = hz.harmonize_segment(raw, ticks, cfg.tick_s, cfg.agg)
    else:
        v, obs = hz.harmonize(raw, ticks, cfg.tick_s, cfg.agg)
    return v, obs, ticks


def stage_anomaly(cfg: PipelineConfig, state, v, obs):
    spikes = an.detect_zscore(v, obs, state.anomaly, cfg.k_sigma)
    v, obs, replaced = an.replace(v, obs, spikes, state.anomaly,
                                  cfg.anomaly_policy, cfg.k_sigma)
    new_anom = an.update_state(state.anomaly, v, obs)
    return v, obs, replaced, new_anom


def stage_gapfill(cfg: PipelineConfig, state, v, obs, ticks):
    # exact integer tick-of-day: tick t of this window sits at absolute
    # position tick0 + tick_index*n_ticks + 1 + t; every term is reduced
    # mod seasonal_slots first so int32 stays exact on any horizon
    E, T = v.shape[0], v.shape[-1]
    slots = cfg.seasonal_slots
    base = (cfg.tick0 % slots
            + (state.tick_index % slots) * (cfg.n_ticks % slots))
    tod = (base + 1 + torch.arange(T, dtype=torch.int32,
                                   device=v.device)) % slots
    return gf.gap_fill(v, obs, state.gapfill, ticks, cfg.gap_strategy,
                       tick_of_day=tod[None, :].expand(E, T),
                       use_kernel=cfg.use_kernel)


def stage_normalize(cfg: PipelineConfig, state, v, obs):
    new_norm = nz.update(state.norm, v, obs)
    return nz.znorm(new_norm, v), new_norm


def stage_features(cfg: PipelineConfig, v_norm, v_raw, obs, filled, ticks):
    mask = obs | filled
    w = cfg.weights(v_norm.device)
    kw = dict(per_tick=cfg.per_tick_features, feature_agg=cfg.feature_agg,
              use_kernel=cfg.use_kernel)
    feats = agg.feature_vector(v_norm, mask, w, **kw)
    raw = agg.feature_vector(v_raw, mask, w, **kw)
    quality = obs.to(torch.float32).mean(dim=(1, 2))
    return FeatureFrame(feats, raw, quality, ticks[:, -1])


# ---------------------------------------------------------------------------
# Fused tick
# ---------------------------------------------------------------------------

def tick(cfg: PipelineConfig, state: PipelineState, raw: RawWindow,
         window_start):
    """One full Percepta tick. Returns (new_state, FeatureFrame, TickFrame)."""
    v, obs, ticks = stage_harmonize(cfg, state, raw, window_start)
    v, obs, replaced, new_anom = stage_anomaly(cfg, state, v, obs)
    v, filled, new_gap = stage_gapfill(cfg, state, v, obs, ticks)
    v_norm, new_norm = stage_normalize(cfg, state, v, obs | filled)
    features = stage_features(cfg, v_norm, v, obs, filled, ticks)

    big = 3.4e38
    ts_b = torch.where(raw.valid, raw.timestamps, -big)
    last_ts = ts_b.amax(-1)
    has = last_ts > -big
    is_last = (ts_b == last_ts[..., None]) & raw.valid
    last_v = (raw.values * is_last.to(torch.float32)).sum(-1) / \
        is_last.sum(-1).clamp(min=1)
    new_state = PipelineState(
        gapfill=new_gap, anomaly=new_anom, norm=new_norm,
        prev_value=torch.where(has, last_v, state.prev_value),
        # no observation this window: re-express the old carry in this
        # window's frame so it keeps receding one window length per tick
        prev_ts=torch.where(has, last_ts,
                            state.prev_ts - cfg.n_ticks * cfg.tick_s),
        tick_index=state.tick_index + 1,
    )
    return new_state, features, TickFrame(v, obs, filled, replaced)


def run_many(cfg: PipelineConfig, state: PipelineState, raws: RawWindow,
             window_starts):
    """K windows through K :func:`tick` calls, the state carried between.

    ``raws`` leaves carry a leading K axis (K, E, S, M); ``window_starts``
    is (K, E). Returns ``(final_state, FeatureFrame, TickFrame)`` with the
    frame leaves stacked along a leading K axis — exactly the outputs of K
    sequential ``tick`` calls, bit for bit (each window runs the same ops
    on the same shapes).
    """
    feats, frames = [], []
    for k in range(raws.values.shape[0]):
        raw = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
        state, f, fr = tick(cfg, state, raw, window_starts[k])
        feats.append(f)
        frames.append(fr)
    stack = lambda items, cls: cls(*(torch.stack(x) for x in zip(*items)))
    return state, stack(feats, FeatureFrame), stack(frames, TickFrame)


class DecideBatch(NamedTuple):
    """Per-window outputs of the fused decision loop (leading K axis):
    what the Manager's host side needs, and nothing bigger. The quality
    metrics are exact per-env int32 counts over the (S, T) tick grid, so
    the host divides them in float64 and reproduces ``np.mean`` over the
    full frame bit for bit without fetching the (K, E, S, T) frames.
    ``features`` is fetched only when a host sink (LogDB) needs it."""
    actions: torch.Tensor    # (K, E, A) validated actions
    rewards: torch.Tensor    # (K, E)
    per_term: torch.Tensor   # (K, E, n_terms)
    violated: torch.Tensor   # (K, E) bool
    features: torch.Tensor   # (K, E, F)
    observed: torch.Tensor   # (K, E) int32 counts over (S, T)
    filled: torch.Tensor     # (K, E) int32
    anomalous: torch.Tensor  # (K, E) int32


def _counts(mask):
    return mask.sum(dim=(1, 2), dtype=torch.int32)


def run_many_decide(cfg: PipelineConfig, decide, state: PipelineState,
                    dstate, raws: RawWindow, window_starts):
    """:func:`run_many` with the decision step after every tick.

    ``decide`` is a ``(step, bank)`` pair (``runtime.predictor.DecideFns``):
    ``step`` runs one window's policy, validation and reward, exactly the
    per-window ops of ``Predictor.on_tick``, and returns that window's
    replay transition; ``bank`` writes the K stacked transitions into the
    ring once, after the loop. Only the small prev/tick/carry part of
    ``dstate`` changes inside the loop. Returns ``(final_state,
    final_dstate, DecideBatch)``."""
    step, bank = decide
    outs, trans = [], []
    for k in range(raws.values.shape[0]):
        raw = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
        state, feats, frame = tick(cfg, state, raw, window_starts[k])
        dstate, (actions, reward, per_term, violated), tr = step(dstate,
                                                                 feats)
        outs.append(DecideBatch(actions, reward, per_term, violated,
                                feats.features, _counts(frame.observed),
                                _counts(frame.filled),
                                _counts(frame.anomalous)))
        trans.append(tr)
    stacked = tuple(torch.stack(x) for x in zip(*trans))
    dstate = dstate._replace(replay=bank(dstate.replay, stacked))
    return state, dstate, DecideBatch(*(torch.stack(x) for x in zip(*outs)))


class PerceptaPipeline:
    """User-facing handle; ``mode`` is ``fused``, ``scan`` or
    ``scan_fused_decide``.

    ``run_tick`` runs one window in any mode; :meth:`run_many` runs a
    K-window batch, and :meth:`run_many_decide` a K-window batch with the
    decision step (``scan_fused_decide`` only, which needs ``decide=``; the
    decision carry is passed to each call). Other modes of the reference raise and name the
    ROADMAP item that brings them. ``device=None`` means the CUDA card.
    """

    def __init__(self, cfg: PipelineConfig, mode: str = "fused",
                 device=None, decide=None):
        if mode in NOT_PORTED_MODES:
            raise ValueError(f"pipeline mode {mode!r} is not ported yet: "
                             f"{NOT_PORTED_MODES[mode]}")
        if mode not in MODES:
            raise ValueError(f"unknown pipeline mode {mode!r}")
        if mode == "scan_fused_decide" and decide is None:
            raise ValueError("scan_fused_decide needs decide=")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.decide = decide

    def init_state(self):
        return init_state(self.cfg, self.device)

    def run_many(self, state, raws: RawWindow, window_starts):
        if self.mode == "scan_fused_decide":
            raise RuntimeError("scan_fused_decide carries a decide state: "
                               "use run_many_decide(state, dstate, ...)")
        return run_many(self.cfg, state, raws, window_starts)

    def run_many_decide(self, state, dstate, raws: RawWindow,
                        window_starts):
        """K windows and their decisions; returns ``(new_state,
        new_dstate, DecideBatch)``. The ring in ``dstate`` is written in
        place."""
        if self.mode != "scan_fused_decide":
            raise RuntimeError(f"run_many_decide needs mode "
                               f"'scan_fused_decide', not {self.mode!r}")
        return run_many_decide(self.cfg, self.decide, state, dstate, raws,
                               window_starts)

    def run_tick(self, state, raw: RawWindow, window_start):
        return tick(self.cfg, state, raw, window_start)
