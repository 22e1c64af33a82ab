"""PerceptaPipeline — the per-tick program, port of ``repro.core.pipeline``.

Modes:
  * ``fused`` — one :func:`tick` per window (the reference).
  * ``modular`` — the paper's architecture as drawn: each stage
    (harmonize, anomaly, gap-fill, normalize, features) is its own call,
    and the host waits for the card after each one. The same ops as
    ``fused``, so the same bits.
  * ``scan``  — :func:`run_many`: K pre-batched windows through K ticks in
    one call, the state carried on the device between them. Outputs are
    exactly those of K sequential ticks (the same ops on the same shapes).
  * ``scan_fused_decide`` — :func:`run_many_decide`: the same K ticks with
    the Predictor's per-window decision step after each one and the K
    replay transitions banked once after the loop; the host gets only the
    small :class:`DecideBatch`.
  * ``scan_sharded`` / ``scan_fused_decide_sharded`` — the same engines
    with the env rows split over an ``EnvMesh``
    (``distribution.sharding``): each shard runs :func:`run_many` or
    :func:`run_many_decide` over its own rows, and the outputs gather back
    on the mesh's first device, bit for bit those of the unsharded engine
    (:func:`make_run_many_sharded`, :func:`make_run_many_decide_sharded`).

Elastic slot pools (``elastic=True``): the env axis holds ``E`` slots, of
which an ``active`` (E,) bool device mask marks the live ones. The host
feeds inactive slots all-invalid windows, under which every stage's state
update is a no-op, and :func:`mask_env_rows` zeroes their outputs; live
rows equal a dense system's over the same envs bit for bit.

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

import dataclasses
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
from repro_torch.distribution import sharding as sh
from repro_torch.kernels._build import on_device
from repro_torch.train import tree as tr

MODES = ("fused", "modular", "scan", "scan_fused_decide", "scan_sharded",
         "scan_fused_decide_sharded")
SHARDED_MODES = ("scan_sharded", "scan_fused_decide_sharded")


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
    interp_streams: bool = False # interpolating harmonizer instead
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

def next_state(cfg: PipelineConfig, state: PipelineState, raw: RawWindow,
               new_gap, new_anom, new_norm) -> PipelineState:
    """The state after a window: the stages' new stats, the cross-window
    carry (the window's last sample per stream, else the old carry
    re-expressed one window later) and the tick counter."""
    big = 3.4e38
    ts_b = torch.where(raw.valid, raw.timestamps, -big)
    last_ts = ts_b.amax(-1)
    has = last_ts > -big
    is_last = (ts_b == last_ts[..., None]) & raw.valid
    last_v = (raw.values * is_last.to(torch.float32)).sum(-1) / \
        is_last.sum(-1).clamp(min=1)
    return PipelineState(
        gapfill=new_gap, anomaly=new_anom, norm=new_norm,
        prev_value=torch.where(has, last_v, state.prev_value),
        # no observation this window: re-express the old carry in this
        # window's frame so it keeps receding one window length per tick
        prev_ts=torch.where(has, last_ts,
                            state.prev_ts - cfg.n_ticks * cfg.tick_s),
        tick_index=state.tick_index + 1,
    )


def tick(cfg: PipelineConfig, state: PipelineState, raw: RawWindow,
         window_start):
    """One full Percepta tick. Returns (new_state, FeatureFrame, TickFrame)."""
    v, obs, ticks = stage_harmonize(cfg, state, raw, window_start)
    v, obs, replaced, new_anom = stage_anomaly(cfg, state, v, obs)
    v, filled, new_gap = stage_gapfill(cfg, state, v, obs, ticks)
    v_norm, new_norm = stage_normalize(cfg, state, v, obs | filled)
    features = stage_features(cfg, v_norm, v, obs, filled, ticks)
    new_state = next_state(cfg, state, raw, new_gap, new_anom, new_norm)
    return new_state, features, TickFrame(v, obs, filled, replaced)


def modular_tick(cfg: PipelineConfig, state: PipelineState, raw: RawWindow,
                 window_start):
    """:func:`tick` stage by stage, as the paper draws the architecture:
    after each stage the host waits for the card (the reference's
    ``block_until_ready``) before it launches the next. The same ops on
    the same tensors as :func:`tick`, so the same bits."""
    def wait(out):
        if raw.values.is_cuda:
            torch.cuda.synchronize(raw.values.device)
        return out

    v, obs, ticks = wait(stage_harmonize(cfg, state, raw, window_start))
    v, obs, replaced, new_anom = wait(stage_anomaly(cfg, state, v, obs))
    v, filled, new_gap = wait(stage_gapfill(cfg, state, v, obs, ticks))
    v_norm, new_norm = wait(stage_normalize(cfg, state, v, obs | filled))
    features = wait(stage_features(cfg, v_norm, v, obs, filled, ticks))
    new_state = next_state(cfg, state, raw, new_gap, new_anom, new_norm)
    return new_state, features, TickFrame(v, obs, filled, replaced)


def mask_env_rows(tree, active):
    """Zero every env row of ``tree``'s leaves where ``active`` (E,) bool
    is False: one launch per leaf, a ``torch.where`` against a Python 0
    (a kernel argument, not a tensor to fill) or, for a bool leaf, an
    ``&``. Live rows pass through bit for bit and inactive rows become
    zeros of the leaf's dtype (whatever a cold slot computed, NaN
    included). The mask is never used to compact, sort or index rows.
    Eager torch fuses nothing across the select, so the reference's
    ``optimization_barrier`` fences have no counterpart here."""
    def leaf(x):
        m = active.reshape(active.shape + (1,) * (x.dim() - 1))
        return m & x if x.dtype == torch.bool else torch.where(m, x, 0)
    return type(tree)(*(leaf(x) for x in tree))


def run_many(cfg: PipelineConfig, state: PipelineState, raws: RawWindow,
             window_starts, active=None):
    """K windows through K :func:`tick` calls, the state carried between.

    ``raws`` leaves carry a leading K axis (K, E, S, M); ``window_starts``
    is (K, E). Returns ``(final_state, FeatureFrame, TickFrame)`` with the
    frame leaves stacked along a leading K axis — exactly the outputs of K
    sequential ``tick`` calls, bit for bit (each window runs the same ops
    on the same shapes).

    ``active`` (E,) bool device tensor is the elastic slot mask: each
    window's outputs are zeroed on inactive rows. The state needs no
    gating (inactive slots get all-invalid windows from the host).
    """
    feats, frames = [], []
    for k in range(raws.values.shape[0]):
        raw = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
        state, f, fr = tick(cfg, state, raw, window_starts[k])
        if active is not None:
            f, fr = mask_env_rows(f, active), mask_env_rows(fr, active)
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
    final_dstate, DecideBatch)``.

    Elastic slot pools ride the decide carry: with ``dstate.active`` set
    (an (E,) bool device tensor the host rewrites between batches), each
    window's pipeline outputs are zeroed on inactive rows (the step masks
    its own), and the bank marks ring rows valid per env: window 0's
    transition closes a pair begun in the last batch, so it is valid only
    where ``prev_ok & active`` (a slot attached this batch has no previous
    window), later windows wherever ``active``. The scalar cursor chain,
    and with it every ring position, is the dense engine's."""
    step, bank = decide
    active = dstate.active
    outs, trans = [], []
    for k in range(raws.values.shape[0]):
        raw = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
        state, feats, frame = tick(cfg, state, raw, window_starts[k])
        if active is not None:
            feats = mask_env_rows(feats, active)
            frame = mask_env_rows(frame, active)
        dstate, (actions, reward, per_term, violated), tr = step(dstate,
                                                                 feats)
        outs.append(DecideBatch(actions, reward, per_term, violated,
                                feats.features, _counts(frame.observed),
                                _counts(frame.filled),
                                _counts(frame.anomalous)))
        trans.append(tr)
    stacked = tuple(torch.stack(x) for x in zip(*trans))
    if active is None:
        dstate = dstate._replace(replay=bank(dstate.replay, stacked))
    else:
        K = len(trans)
        env_mask = torch.cat([(active & dstate.prev_ok)[None],
                              active[None].expand(K - 1, -1)])
        dstate = dstate._replace(
            replay=bank(dstate.replay, stacked, env_mask=env_mask),
            prev_ok=dstate.prev_ok | active)
    return state, dstate, DecideBatch(*(torch.stack(x) for x in zip(*outs)))


def _shard_cfg(cfg: PipelineConfig, mesh) -> PipelineConfig:
    if cfg.n_envs % mesh.size:
        raise ValueError(f"{cfg.n_envs} envs do not split over "
                         f"{mesh.size} shards")
    return dataclasses.replace(cfg, n_envs=cfg.n_envs // mesh.size)


def _split_batch(mesh, raws, window_starts, active=None):
    """The batch's per-shard parts: the (K, E, ...) leaves split on dim 1,
    ``active`` (E,) on dim 0; views where a shard's device is the batch's
    (the engine only reads them)."""
    batch = sh.place_env_tree((raws, window_starts), 1, mesh, copy=False)
    if active is None:
        return [b + (None,) for b in batch]
    act = sh.place_env_tree(active, 0, mesh, copy=False)
    return [b + (a,) for b, a in zip(batch, act)]


def make_run_many_sharded(cfg: PipelineConfig, mesh=None,
                          elastic: bool = False):
    """Env-sharded scan engine: :func:`run_many` over each shard's rows.

    Returns ``(fn, mesh)``; ``fn(states, raws, window_starts[, active])``
    takes the per-shard states (``sharding.place_env_tree(state, 0,
    mesh)``), the whole (K, E, S, M) batch and (K, E) starts (split here
    on dim 1) and, with ``elastic=True``, the whole (E,) ``active`` mask
    (split on dim 0). It launches every shard before anything is read
    (nothing is: the engine never waits for the card) and returns ``(new
    per-shard states, FeatureFrame, TickFrame)``, the frames gathered on
    the mesh's first device. The tick is per-env (no stage reduces across
    envs), so the outputs equal :func:`run_many`'s bit for bit; the
    replicated ``tick_index`` advances on every shard alike. ``mesh``
    defaults to ``sharding.env_mesh(cfg.n_envs)``."""
    if mesh is None:
        mesh = sh.env_mesh(cfg.n_envs)
    scfg = _shard_cfg(cfg, mesh)

    def fn(states, raws, window_starts, active=None):
        if elastic != (active is not None):
            raise ValueError("an elastic engine takes the (E,) active mask "
                             "with every batch, a dense one none")
        outs = []
        for dev, state, part in zip(mesh.devices, states,
                                    _split_batch(mesh, raws, window_starts,
                                                 active)):
            with on_device(dev):
                outs.append(run_many(scfg, state, *part))
        new_states, feats, frames = zip(*outs)
        return (tuple(new_states), sh.gather_env_tree(feats, 1),
                sh.gather_env_tree(frames, 1))

    return fn, mesh


def make_run_many_decide_sharded(cfg: PipelineConfig, decide, dstate=None,
                                 mesh=None):
    """Env-sharded fused decision engine: :func:`run_many_decide` over each
    shard's rows.

    Returns ``(fn, mesh)``; ``fn(states, dstates, raws, window_starts)``
    takes the per-shard pipeline states and decide carries (the carry
    placed with ``sharding.decide_specs``: prev rows, model carry, masks
    and ring rows split on dim 0, the policy params and the ``have_prev``
    / ``tick`` / version / ring ``cursor`` scalars replicated), splits the
    batch on dim 1 and returns ``(states, dstates, DecideBatch)``, the
    batch gathered on the mesh's first device. Each shard writes its own
    ring in place with its own cursor; every shard sees the same scalar
    chain, so ring positions are the unsharded engine's. The decision math
    must be per-env row-wise, which ``analysis.certify`` checks of the
    policy. ``dstate`` (a template, optional) lets a closure-only model be
    refused here: its weights live in the closure, on one device, and
    cannot follow the shards to another card."""
    if mesh is None:
        mesh = sh.env_mesh(cfg.n_envs)
    scfg = _shard_cfg(cfg, mesh)
    if (dstate is not None and mesh.physical > 1
            and not tr.leaves(dstate.policy)):
        raise ValueError(
            "scan_fused_decide_sharded over more than one device needs the "
            "policy's weights in DecideState.policy (a ModelAdapter with "
            "params= and apply=): a closure-only model keeps them on one "
            "device, and the shards on the other devices could not read "
            "them")

    def fn(states, dstates, raws, window_starts):
        outs = []
        for dev, state, dstate, part in zip(
                mesh.devices, states, dstates,
                _split_batch(mesh, raws, window_starts)):
            with on_device(dev):
                outs.append(run_many_decide(scfg, decide, state, dstate,
                                            *part[:2]))
        new_states, new_dstates, batches = zip(*outs)
        return (tuple(new_states), tuple(new_dstates),
                sh.gather_env_tree(batches, 1))

    return fn, mesh


class PerceptaPipeline:
    """User-facing handle; ``mode`` is one of :data:`MODES`.

    ``run_tick`` runs one window in the unsharded modes (stage by stage
    in ``modular``); :meth:`run_many` runs a K-window batch, and
    :meth:`run_many_decide` a K-window batch with the decision step
    (the fused-decide modes, which need ``decide=``; the decision carry
    is passed to each call). ``elastic=True`` marks the env axis a slot
    pool: :meth:`run_many` then takes the (E,) ``active`` mask (the
    fused-decide modes carry it in the decide state). ``device=None``
    means the CUDA card.

    The sharded modes split the env rows over ``mesh`` (default:
    ``sharding.env_mesh`` over ``sharding.visible_devices(device)``): the
    state (:meth:`init_state`, :meth:`place_state`) and the decide carry
    (:meth:`place_decide`) are tuples of per-shard trees, and outputs come
    back whole on the mesh's first device. :meth:`gather_state` and
    :meth:`gather_decide` give the unsharded view. ``decide_state`` (a
    template) lets a closure-only model be refused on a mesh of more
    than one card.
    """

    def __init__(self, cfg: PipelineConfig, mode: str = "fused",
                 device=None, decide=None, elastic: bool = False,
                 mesh=None, decide_state=None):
        if mode not in MODES:
            raise ValueError(f"unknown pipeline mode {mode!r}")
        self.fused_decide = mode in ("scan_fused_decide",
                                     "scan_fused_decide_sharded")
        if self.fused_decide and decide is None:
            raise ValueError(f"{mode} needs decide=")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.decide = decide
        self.elastic = bool(elastic)
        self.mesh = None
        self._sharded = None
        if mode in SHARDED_MODES:
            self.mesh = mesh if mesh is not None else sh.env_mesh(
                cfg.n_envs, sh.visible_devices(self.device))
            if self.fused_decide:
                self._sharded, _ = make_run_many_decide_sharded(
                    cfg, decide, decide_state, self.mesh)
            else:
                self._sharded, _ = make_run_many_sharded(cfg, self.mesh,
                                                         self.elastic)

    # --- placement (sharded modes; identity otherwise) ----------------------
    def place_state(self, state):
        """A whole pipeline state as the engine's state: per-shard copies
        in the sharded modes, ``state`` itself otherwise."""
        if self.mesh is None:
            return state
        return sh.place_env_tree(state, 0, self.mesh)

    def gather_state(self, state):
        """The engine's state as one whole tree on the first device."""
        if self.mesh is None:
            return state
        return sh.gather_env_tree(state, 0)

    def place_decide(self, dstate):
        """A whole ``DecideState`` as the engine's carry (policy params
        replicated, ``sharding.decide_specs``)."""
        if self.mesh is None:
            return dstate
        return sh.place_env_tree(dstate, 0, self.mesh,
                                 sh.decide_specs(dstate, 0))

    def gather_decide(self, dstate):
        if self.mesh is None:
            return dstate
        return sh.gather_env_tree(dstate, 0, sh.decide_specs(dstate[0], 0))

    def init_state(self):
        return self.place_state(init_state(self.cfg, self.device))

    def run_many(self, state, raws: RawWindow, window_starts, active=None):
        """K windows in one call; ``active`` (E,) bool is required iff the
        pipeline is elastic."""
        if self.fused_decide:
            raise RuntimeError(f"{self.mode} carries a decide state: "
                               "use run_many_decide(state, dstate, ...)")
        if self.elastic != (active is not None):
            raise ValueError("an elastic pipeline takes the (E,) active "
                             "mask with every batch, a dense one none")
        if self._sharded is not None:
            return self._sharded(state, raws, window_starts, active)
        return run_many(self.cfg, state, raws, window_starts, active)

    def run_many_decide(self, state, dstate, raws: RawWindow,
                        window_starts):
        """K windows and their decisions; returns ``(new_state,
        new_dstate, DecideBatch)``. The ring in ``dstate`` (each shard's,
        when sharded) is written in place."""
        if not self.fused_decide:
            raise RuntimeError(f"run_many_decide needs mode "
                               f"'scan_fused_decide' or its sharded twin, "
                               f"not {self.mode!r}")
        first = dstate[0] if self._sharded is not None else dstate
        if self.elastic != (first.active is not None):
            raise ValueError("an elastic pipeline's decide state carries "
                             "the active/prev_ok masks, a dense one none")
        if self._sharded is not None:
            return self._sharded(state, dstate, raws, window_starts)
        return run_many_decide(self.cfg, self.decide, state, dstate, raws,
                               window_starts)

    def run_tick(self, state, raw: RawWindow, window_start):
        if self.mesh is not None:
            raise RuntimeError(f"{self.mode} runs window batches: use "
                               "run_many / run_many_decide")
        if self.mode == "modular":
            return modular_tick(self.cfg, state, raw, window_start)
        return tick(self.cfg, state, raw, window_start)
