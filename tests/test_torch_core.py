"""The port's tick stages and ``tick`` itself against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
masks (observed, filled, anomalous, spikes) and counts must match exactly;
floats use rtol = atol = 1e-5, the repo's own single-module bound
(XLA and torch add in different orders). ``run_many`` must equal K port
``tick`` calls bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import PerceptaPipeline as JaxPipeline
from repro.core import PipelineConfig as JaxConfig
from repro.core import aggregate as jagg
from repro.core import anomaly as jan
from repro.core import gapfill as jgf
from repro.core import harmonize as jhz
from repro.core import normalize as jnz
from repro.core.frame import make_raw_window as jax_raw_window
from repro_torch import convert
from repro_torch.core import PipelineConfig, run_many, tick
from repro_torch.core import aggregate as agg
from repro_torch.core import anomaly as an
from repro_torch.core import gapfill as gf
from repro_torch.core import harmonize as hz
from repro_torch.core import normalize as nz
from repro_torch.core.frame import RawWindow, make_raw_window

TOL = dict(rtol=1e-5, atol=1e-5)
T_ = lambda x: torch.from_numpy(np.array(x))  # a writable private copy
E, S, T, M = 3, 4, 8, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    got = [g.numpy() for g in got] if isinstance(got, tuple) else got.numpy()
    assert_allclose(got, np.asarray(want), **(tol or TOL))


def _raw(rng, e=E, s=S, m=M, t=T):
    return (rng.normal(5, 2, (e, s, m)).astype(np.float32),
            rng.uniform(0, t * 60, (e, s, m)).astype(np.float32),
            rng.rand(e, s, m) > 0.3)


def _ticks(e=E, t=T):
    return np.broadcast_to(np.arange(1, t + 1, dtype=np.float32) * 60.0,
                           (e, t)).copy()


# ------------------------------------------------------------- harmonize
@pytest.mark.parametrize("m,t", [(24, 8), (1024, 16)])  # dense | scatter
@pytest.mark.parametrize("a", list(hz.AGGS))
def test_harmonize_segment_both_branches(m, t, a, rng):
    assert (m * t <= hz._DENSE_MT_MAX) == (m * t <= jhz._DENSE_MT_MAX)
    v, ts, ok = _raw(rng, 2, 3, m, t)
    ticks = _ticks(2, t)
    want_v, want_o = jhz.harmonize_segment(jax_raw_window(v, ts, ok),
                                           jnp.asarray(ticks), 60.0, a)
    got_v, got_o = hz.harmonize_segment(make_raw_window(v, ts, ok,
                                                        device="cpu"),
                                        T_(ticks), 60.0, a)
    assert np.array_equal(got_o.numpy(), np.asarray(want_o))
    _close(got_v, want_v)


@pytest.mark.parametrize("a", list(hz.AGGS) + ["per-stream"])
def test_harmonize_onehot(a, rng):
    v, ts, ok = _raw(rng)
    ticks = _ticks()
    sa = np.arange(S) % len(hz.AGGS) if a == "per-stream" else None
    kw = dict(agg="mean" if sa is not None else a)
    want_v, want_o = jhz.harmonize(jax_raw_window(v, ts, ok),
                                   jnp.asarray(ticks), 60.0,
                                   stream_agg=None if sa is None
                                   else jnp.asarray(sa), **kw)
    got_v, got_o = hz.harmonize(make_raw_window(v, ts, ok, device="cpu"),
                                T_(ticks), 60.0,
                                stream_agg=sa, **kw)
    assert np.array_equal(got_o.numpy(), np.asarray(want_o))
    _close(got_v, want_v)


def test_tick_grid_and_bucketize(rng):
    v, ts, ok = _raw(rng)
    ws = rng.uniform(0, 100, (E,)).astype(np.float32)
    want_grid = jhz.tick_grid(jnp.asarray(ws), 60.0, T)
    got_grid = hz.tick_grid(T_(ws), 60.0, T)
    assert np.array_equal(got_grid.numpy(), np.asarray(want_grid))
    want_i, want_ok = jhz.bucketize(jax_raw_window(v, ts, ok), want_grid, 60.)
    got_i, got_ok = hz.bucketize(make_raw_window(v, ts, ok, device="cpu"),
                                 got_grid, 60.)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))


# ---------------------------------------------------------------- anomaly
def _warm_anomaly(rng):
    st = jan.init_state(E, S)
    for _ in range(3):
        v = jnp.asarray(rng.normal(5, 1, (E, S, T)).astype(np.float32))
        st = jan.update_state(st, v, jnp.asarray(rng.rand(E, S, T) > 0.2))
    return st


@pytest.mark.parametrize("policy", an.POLICIES)
def test_anomaly_detect_replace_update(policy, rng):
    st = _warm_anomaly(rng)
    v = rng.normal(5, 3, (E, S, T)).astype(np.float32)
    o = rng.rand(E, S, T) > 0.2
    pst = an.AnomalyState(*(T_(x) for x in _np(st)))
    want_sp = jan.detect_zscore(jnp.asarray(v), jnp.asarray(o), st, 1.5)
    got_sp = an.detect_zscore(T_(v), T_(o), pst, 1.5)
    assert np.array_equal(got_sp.numpy(), np.asarray(want_sp))
    assert got_sp.any()
    wv, wo, wr = jan.replace(jnp.asarray(v), jnp.asarray(o), want_sp, st,
                             policy, 1.5)
    gv, go, gr = an.replace(T_(v), T_(o), got_sp, pst, policy, 1.5)
    assert np.array_equal(go.numpy(), np.asarray(wo))
    assert np.array_equal(gr.numpy(), np.asarray(wr))
    _close(gv, wv)
    want = jan.update_state(st, wv, wo)
    got = an.update_state(pst, gv, go)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------- gap-fill
def _gap_inputs(rng, t=T):
    v = rng.normal(5, 2, (E, S, t)).astype(np.float32)
    o = rng.rand(E, S, t) > 0.5
    o[0, 0] = False
    ticks = _ticks(E, t)
    tod = (np.arange(t, dtype=np.int32)[None] + 5) % 24
    tod = np.broadcast_to(tod, (E, t)).copy()
    return v, o, ticks, tod


# jitted: eager dispatch of the associative scan's many slices (the t=80
# branch) compiles op by op and costs seconds
_jax_locf_fill = jax.jit(lambda v, o, st, ticks, tod: jgf.gap_fill(
    v, o, st, ticks, "locf", tick_of_day=tod))


def _warm_gapfill(rng, t):
    st = jgf.init_state(E, S)
    for _ in range(2):
        v, o, ticks, tod = _gap_inputs(rng, t)
        _, _, st = _jax_locf_fill(jnp.asarray(v), jnp.asarray(o), st,
                                  jnp.asarray(ticks), jnp.asarray(tod))
    return st


# use_kernel only reaches the string "locf" strategy
@pytest.mark.parametrize("t", [8, 80])   # locf dense | scan branch
@pytest.mark.parametrize("strategy,use_kernel",
                         [(s, False) for s in gf.STRATEGIES]
                         + [("per-stream", False), ("locf", True)])
def test_gap_fill(t, strategy, use_kernel, rng):
    st = _warm_gapfill(rng, t)
    v, o, ticks, tod = _gap_inputs(rng, t)
    strat = (np.arange(S, dtype=np.int32) % 4 if strategy == "per-stream"
             else strategy)
    jstrat = jnp.asarray(strat) if strategy == "per-stream" else strat
    jfn = lambda v, o, st, ticks, tod: jgf.gap_fill(
        v, o, st, ticks, jstrat, tick_of_day=tod, use_pallas=use_kernel)
    if t > jgf._DENSE_T_MAX:
        jfn = jax.jit(jfn)   # see _jax_locf_fill
    wv, wf, wst = jfn(jnp.asarray(v), jnp.asarray(o), st,
                      jnp.asarray(ticks), jnp.asarray(tod))
    pst = gf.GapFillState(*(T_(x) for x in _np(st)))
    gv, gfl, gst = gf.gap_fill(T_(v), T_(o), pst, T_(ticks), strat,
                               tick_of_day=T_(tod), use_kernel=use_kernel)
    assert np.array_equal(gfl.numpy(), np.asarray(wf))
    assert gfl.any()
    _close(gv, wv)
    if strategy == "locf":   # pure selection: exact
        assert np.array_equal(gv.numpy(), np.asarray(wv))
    for g, w in zip(gst, wst):
        _close(g, w)


@pytest.mark.parametrize("t", [8, 80])
def test_locf_scan_no_observation_convention(t, rng):
    """Where no observation exists yet, the dense branch returns 0 and the
    scan branch the carry-in value — as the reference's two branches do."""
    v = rng.normal(0, 1, (2, t)).astype(np.float32)
    o = np.zeros((2, t), bool)
    iv = np.array([7.0, 8.0], np.float32)
    ih = np.zeros(2, bool)
    want_v, want_h = jax.jit(jgf._locf_scan)(
        jnp.asarray(v), jnp.asarray(o), jnp.asarray(iv), jnp.asarray(ih))
    got_v, got_h = gf._locf_scan(T_(v), T_(o), T_(iv), T_(ih))
    assert np.array_equal(got_h.numpy(), np.asarray(want_h))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


# -------------------------------------------------------------- normalize
def test_normalize(rng):
    st = jnz.init_state(E, S)
    pst = nz.NormState(*(T_(x) for x in _np(st)))
    for _ in range(3):
        v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
        o = rng.rand(E, S, T) > 0.4
        o[0, 0] = False
        st = jnz.update(st, jnp.asarray(v), jnp.asarray(o))
        pst = nz.update(pst, T_(v), T_(o))
        for g, w in zip(pst, st):
            _close(g, w)
    _close(nz.znorm(pst, T_(v)), jnz.znorm(st, jnp.asarray(v)))
    z = rng.normal(0, 1, (E, S, T)).astype(np.float32)
    _close(nz.denorm_z(pst, T_(z)), jnz.denorm_z(st, jnp.asarray(z)))
    _close(nz.minmax(pst, T_(v)), jnz.minmax(st, jnp.asarray(v)))


# -------------------------------------------------------------- aggregate
@pytest.mark.parametrize("a", list(agg.AGGS))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_window_agg(a, use_kernel, rng):
    v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
    m = rng.rand(E, S, T) > 0.4
    m[0, 0] = False                         # empty-window fix-ups
    want = jagg.window_agg(jnp.asarray(v), jnp.asarray(m), a,
                           use_pallas=use_kernel)
    got = agg.window_agg(T_(v), T_(m), a, use_kernel=use_kernel)
    if a in ("last", "min", "max", "count"):
        assert np.array_equal(got.numpy(), np.asarray(want))
    _close(got, want)


@pytest.mark.parametrize("feature_agg", ["last", "mean"])
@pytest.mark.parametrize("per_tick", [False, True])
def test_feature_vector_and_combine(feature_agg, per_tick, rng):
    v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
    m = rng.rand(E, S, T) > 0.4
    w = rng.normal(0, 1, (2, S)).astype(np.float32)
    want = jagg.feature_vector(jnp.asarray(v), jnp.asarray(m),
                               jnp.asarray(w), per_tick=per_tick,
                               feature_agg=feature_agg, use_pallas=True)
    got = agg.feature_vector(T_(v), T_(m), T_(w), per_tick=per_tick,
                             feature_agg=feature_agg, use_kernel=True)
    _close(got, want)


# -------------------------------------------------------------------- tick
def _cfgs(**kw):
    base = dict(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0,
                max_samples=M, k_sigma=3.0, feature_agg="mean", tick0=7)
    base.update(kw)
    return JaxConfig(use_pallas=True, **base), \
        PipelineConfig(use_kernel=True, **base)


@pytest.mark.parametrize("gap_strategy", ["locf", "linear", "ewma",
                                          "seasonal"])
@pytest.mark.parametrize("anomaly_policy", ["clip", "mean", "missing"])
def test_tick_matches_jax_from_warmed_state(gap_strategy, anomaly_policy,
                                            rng):
    jcfg, cfg = _cfgs(gap_strategy=gap_strategy,
                      anomaly_policy=anomaly_policy)
    jp = JaxPipeline(jcfg)
    ws = np.zeros((E,), np.float32)
    st = jp.init_state()
    for _ in range(3):   # warm every carry (anomaly stats need count > 8)
        st, _, _ = jp.run_tick(st, jax_raw_window(*_raw(rng)), ws)
    pst = convert.pipeline_state_from_numpy(_np(st))
    win = _raw(rng)
    wst, wfeat, wframe = jp.run_tick(st, jax_raw_window(*win), ws)
    gst, gfeat, gframe = tick(cfg, pst, make_raw_window(*win, device="cpu"),
                                T_(ws))
    for name in ("observed", "filled", "anomalous"):
        assert np.array_equal(getattr(gframe, name).numpy(),
                              np.asarray(getattr(wframe, name))), name
    _close(gframe.values, wframe.values)
    for g, w in zip(gfeat, wfeat):
        _close(g, w)
    for g, w in zip(jax.tree.leaves(tuple(gst)), jax.tree.leaves(wst)):
        if g.dtype == torch.int32:
            assert np.array_equal(g.numpy(), np.asarray(w))
        _close(g, w)


def test_run_many_equals_k_ticks_bitwise(rng):
    _, cfg = _cfgs(gap_strategy="seasonal")
    K = 3
    wins = [_raw(rng) for _ in range(K)]
    raws = make_raw_window(*(np.stack(x) for x in zip(*wins)), device="cpu")
    starts = torch.zeros((K, E))
    st0 = convert.pipeline_state_from_numpy(_np(
        JaxPipeline(_cfgs()[0]).init_state()))
    fst, feats, frames = run_many(cfg, st0, raws, starts)
    st = st0
    for k in range(K):
        raw = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
        st, f, fr = tick(cfg, st, raw, starts[k])
        for a, b in zip(f, feats):
            assert torch.equal(a, b[k])
        for a, b in zip(fr, frames):
            assert torch.equal(a, b[k])
    for a, b in zip(jax.tree.leaves(tuple(st)), jax.tree.leaves(tuple(fst))):
        assert torch.equal(a, b)
    assert int(fst.tick_index) == K and fst.tick_index.dtype == torch.int32


@pytest.mark.parametrize("name", ["pipeline.init_state", "replay.init",
                                  "normalize.init_state",
                                  "gapfill.init_state",
                                  "anomaly.init_state",
                                  "frame.empty_tick_frame"])
def test_state_constructors_default_to_the_card(name):
    """Every state constructor takes ``device=None``, the card, as the
    port's entry points do: where there is no card it raises
    ``resolve_device``'s error rather than build the state on the CPU
    beside an engine on the card; ``device="cpu"`` builds it there."""
    from repro_torch.core import frame, pipeline, replay
    mod, fn = name.split(".")
    mods = {"pipeline": pipeline, "replay": replay, "normalize": nz,
            "gapfill": gf, "anomaly": an, "frame": frame}
    args = {"pipeline": (PipelineConfig(n_envs=E, n_streams=S),),
            "replay": (E, 8, 3, 2), "frame": (E, S, T)}.get(mod, (E, S))
    build = getattr(mods[mod], fn)
    leaves = [x for x in jax.tree.leaves(tuple(build(*args, device="cpu")))
              if torch.is_tensor(x)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(*args)


def test_make_raw_window_defaults_to_the_card(rng):
    """``make_raw_window`` resolves ``device=None`` to the card as the
    reference's puts its window on the default device: where there is no
    card it raises ``resolve_device``'s error rather than build the window
    on the CPU; ``device="cpu"`` builds it there, a copy of the arrays."""
    v, ts, ok = _raw(rng)
    raw = make_raw_window(v, ts, ok, device="cpu")
    assert all(x.device.type == "cpu" for x in raw)
    v[...] = 0.0
    assert not torch.equal(raw.values, torch.zeros_like(raw.values))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_raw_window(v, ts, ok)


@pytest.mark.parametrize("combine", [None, ((1.0, 0.5), (0.0, 2.0))])
def test_pipeline_weights_default_to_the_card(combine):
    """``PipelineConfig.weights`` resolves ``device=None`` to the card like
    the other constructors: where there is no card it raises
    ``resolve_device``'s error rather than build the weights on the CPU;
    ``device="cpu"`` builds them there (identity, or the config's rows)."""
    cfg = PipelineConfig(n_envs=2, n_streams=2, combine_weights=combine)
    w = cfg.weights("cpu")
    want = torch.eye(2) if combine is None else torch.tensor(combine)
    assert w.device.type == "cpu" and torch.equal(w, want)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cfg.weights()
