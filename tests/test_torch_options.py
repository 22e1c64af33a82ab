"""The tick's last options and the system's last consume paths, against the
JAX package: ``core.anomaly.detect_mad`` (and the ``jnp.nanmedian`` it
rests on), ``core.harmonize.harmonize_interp``,
``PipelineConfig(interp_streams=True)`` through the pipeline, the
``modular`` mode and ``PerceptaSystem(batched_consume=False)``.

Tolerances: the median equals ``jnp.nanmedian`` bit for bit (a sort, two
picks and one add: no order to differ in) and ``detect_mad``'s spike mask
exactly; ``harmonize_interp``'s ``observed`` and NaN positions exactly,
its values at rtol = atol = 1e-5 (a quotient and a product-add that XLA
may contract into an FMA); the pipeline's masks exactly, its floats and
the systems' at rtol = atol = 1e-4 (``tests/test_torch_system.py``'s
``TOL``: drift through the normalizer stats over several windows). Within
the port, ``modular`` equals ``fused`` and ``batched_consume=False``
equals ``True`` bit for bit; against JAX, ``modular`` is also held to the
reference's own ``test_system_fused_equals_modular`` bounds (mean reward
within 1e-3, observed fraction within 1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import PipelineConfig as JaxConfig
from repro.core import anomaly as jan
from repro.core import harmonize as jhz
from repro.core import pipeline as jpl
from repro.core.frame import make_raw_window as jax_raw_window
from repro.core.reward import energy_reward_spec as jax_energy
from repro.runtime.predictor import ActionSpace as JaxSpace
from repro.runtime.predictor import Predictor as JaxPredictor
from repro.runtime.predictor import linear_policy as jax_linear
from repro.runtime.receivers import SimulatedDevice as JaxDevice
from repro.runtime.system import PerceptaSystem as JaxSystem
from repro.runtime.system import SourceSpec as JaxSource
from repro_torch import convert
from repro_torch.core import PipelineConfig
from repro_torch.core import anomaly as an
from repro_torch.core import harmonize as hz
from repro_torch.core import pipeline as pl
from repro_torch.core.frame import make_raw_window
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime.policies import linear_builder
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

TOL = dict(rtol=1e-4, atol=1e-4)
INTERP_TOL = dict(rtol=1e-5, atol=1e-5)
T_ = lambda x: torch.from_numpy(np.array(x))


# ----------------------------------------------------------- detect_mad
def _with_nans(rng, shape, n_valid):
    """Rows of ``shape[-1]`` values with exactly ``n_valid[i]`` non-NaN
    entries each, at random places."""
    x = rng.normal(0, 3, shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    for i, n in enumerate(np.resize(n_valid, rows.shape[0])):
        rows[i, rng.permutation(shape[-1])[n:]] = np.nan
    return x


# even counts first: there torch.nanmedian takes the lower middle value
# where jnp.nanmedian averages the two
@pytest.mark.parametrize("counts", [(2, 4, 6, 8), (1, 3, 5, 7), (0, 8, 0, 3)],
                         ids=["even", "odd", "all-nan"])
def test_nanmedian_matches_jnp(counts, rng):
    x = _with_nans(rng, (3, 4, 8), counts)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1, keepdims=True))
    got = an.nanmedian(T_(x)).numpy()
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if counts[0] == 2:
        lower = torch.nanmedian(T_(x), dim=-1, keepdim=True).values.numpy()
        assert not np.array_equal(lower, want)   # the gap this one closes


def test_nanmedian_infinite_middles_match_jnp():
    """Odd counts whose median is +-inf, and an even count between -inf and
    +inf (NaN), as ``jnp.nanmedian`` gives them."""
    inf, nan = np.inf, np.nan
    x = np.array([[1.0, inf, inf, nan], [-inf, -inf, 2.0, nan],
                  [-inf, inf, nan, nan], [inf, 3.0, nan, nan]], np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1, keepdims=True))
    got = an.nanmedian(T_(x)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("p_obs", [1.0, 0.7, 0.0])
@pytest.mark.parametrize("T", [8, 7])
def test_detect_mad_matches_jax(T, p_obs, rng):
    v = rng.normal(10, 1, (4, 3, T)).astype(np.float32)
    v[rng.rand(*v.shape) < 0.1] += 40.0            # spikes
    v[0, 0, 1] = np.inf
    v[1, 2, 0] = np.nan
    obs = rng.rand(*v.shape) < p_obs
    obs[2, 1] = False                              # an all-unobserved row
    want = np.asarray(jan.detect_mad(jnp.asarray(v), jnp.asarray(obs)))
    got = an.detect_mad(T_(v), T_(obs)).numpy()
    assert np.array_equal(got, want)
    if p_obs:
        assert want.any()


def test_detect_mad_window_local():
    """``tests/test_core_ops.py``'s window, through the port."""
    v = torch.tensor([[[1.0, 1.1, 0.9, 50.0, 1.05, 0.95, 1.0, 1.02]]])
    spikes = an.detect_mad(v, torch.ones((1, 1, 8), dtype=torch.bool), k=8.0)
    assert spikes[0, 0].tolist() == [False] * 3 + [True] + [False] * 4


# ------------------------------------------------------ harmonize_interp
def _interp_window(rng, E=3, S=4, M=12, T=8, tick_s=60.0, nonfinite=False):
    # slow sources: a few samples a window, some before the first tick
    ts = rng.uniform(-30, T * tick_s + 30, (E, S, M)).astype(np.float32)
    ts[0, 0, :3] = ts[0, 0, 3]                     # tied timestamps
    vals = rng.normal(5, 2, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) < 0.35
    valid[1, 1] = False                            # a silent stream
    if nonfinite:
        vals[0, 1, :2] = [np.nan, np.inf]
        vals[2, 3, 0] = -np.inf
        valid[0, 1, :2] = valid[2, 3, 0] = True
        vals[1, 2, 1] = np.nan                     # an invalid NaN
    return vals, ts, valid


@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nan-inf"])
@pytest.mark.parametrize("max_gap_s", [0.0, 150.0])
@pytest.mark.parametrize("bridge", [False, True])
def test_harmonize_interp_matches_jax(bridge, max_gap_s, nonfinite, rng):
    E, S, T, tick_s = 3, 4, 8, 60.0
    vals, ts, valid = _interp_window(rng, E, S, T=T, tick_s=tick_s,
                                     nonfinite=nonfinite)
    ticks = (np.arange(1, T + 1, dtype=np.float32) * tick_s)[None] \
        .repeat(E, 0)
    kw = dict(max_gap_s=max_gap_s)
    pkw = dict(max_gap_s=max_gap_s)
    if bridge:
        prev_v = rng.normal(5, 2, (E, S)).astype(np.float32)
        prev_t = rng.uniform(-900, 100, (E, S)).astype(np.float32)
        prev_t[2, 0] = -1e30                       # the init sentinel
        kw.update(prev_value=jnp.asarray(prev_v), prev_ts=jnp.asarray(prev_t))
        pkw.update(prev_value=T_(prev_v), prev_ts=T_(prev_t))
    want, wobs = jhz.harmonize_interp(jax_raw_window(vals, ts, valid),
                                      jnp.asarray(ticks), **kw)
    got, gobs = hz.harmonize_interp(make_raw_window(vals, ts, valid,
                                                    device="cpu"),
                                    T_(ticks), **pkw)
    want, wobs = np.asarray(want), np.asarray(wobs)
    assert np.array_equal(gobs.numpy(), wobs)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert_allclose(got.numpy(), want, **INTERP_TOL)
    # the silent stream stays unobserved unless the carry bridges it
    assert wobs.mean() > 0.3 and (bridge or (~wobs).any())
    if nonfinite:
        assert np.isnan(want).any()


def test_harmonize_interp_bridges():
    """``tests/test_core_ops.py``'s ramp, through the port."""
    raw = make_raw_window(np.array([[[0.0, 100.0]]], np.float32),
                          np.array([[[0.0, 100.0]]], np.float32),
                          device="cpu")
    out, obs = hz.harmonize_interp(raw, torch.tensor([[25.0, 50.0, 75.0]]))
    assert_allclose(out[0, 0].numpy(), [25.0, 50.0, 75.0], rtol=1e-5)
    assert bool(obs.all())


def test_interp_streams_pipeline_matches_jax(rng):
    """``PipelineConfig(interp_streams=True)`` through three ticks of the
    pipeline from the init state, so the carry-in bridge of ticks 2 and 3
    comes from the windows before."""
    E, S, M, T = 3, 4, 12, 8
    kw = dict(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0, max_samples=M,
              interp_streams=True, gap_strategy="locf", feature_agg="mean")
    jcfg, cfg = JaxConfig(**kw), PipelineConfig(**kw)
    jstate = jpl.init_state(jcfg)
    state = pl.PerceptaPipeline(cfg, device="cpu").init_state()
    starts = np.zeros((E,), np.float32)
    for _ in range(3):
        vals, ts, valid = _interp_window(rng, E, S, M, T)
        jstate, jf, jfr = jpl.tick(jcfg, jstate, jax_raw_window(vals, ts,
                                                                valid),
                                   jnp.asarray(starts))
        state, f, fr = pl.tick(cfg, state, make_raw_window(
            vals, ts, valid, device="cpu"), T_(starts))
        for key in ("observed", "filled", "anomalous"):
            assert np.array_equal(getattr(fr, key).numpy(),
                                  np.asarray(getattr(jfr, key))), key
        assert_allclose(fr.values.numpy(), np.asarray(jfr.values), **TOL)
        assert_allclose(f.features.numpy(), np.asarray(jf.features), **TOL)
        assert_allclose(f.raw.numpy(), np.asarray(jf.raw), **TOL)
    want = convert.pipeline_state_from_numpy(jax.tree.map(np.asarray,
                                                          jstate))
    assert torch.equal(state.tick_index, want.tick_index)
    assert_allclose(state.prev_ts.numpy(), want.prev_ts.numpy(), **TOL)
    assert_allclose(state.prev_value.numpy(), want.prev_value.numpy(), **TOL)


# ------------------------------------------------- modular mode, consume
def _sources(spec, device):
    return [spec("meter", "mqtt", device("grid_kw", 60.0, base=3.0, seed=1)),
            spec("price", "http", device("price", 300.0, base=0.2,
                                         amplitude=0.05, seed=2)),
            spec("thermo", "amqp", device("temp_c", 30.0, base=21.0,
                                          amplitude=1.0, seed=3))]


def _port_system(mode, n_envs=4, **kw):
    cfg = PipelineConfig(n_envs=n_envs, n_streams=3, n_ticks=8, tick_s=60.0,
                         max_samples=32, gap_strategy="locf",
                         feature_agg="mean", use_kernel=True)
    pred = Predictor("rglru", energy_reward_spec(1, 0, 2),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     n_envs, cfg.n_features, replay_capacity=64,
                     device="cpu")
    return PerceptaSystem([f"bldg-{i}" for i in range(n_envs)],
                          _sources(SourceSpec, SimulatedDevice), cfg, pred,
                          speedup=5000.0, manual_time=True, mode=mode,
                          scan_k=3, device="cpu", **kw)


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


def test_modular_equals_fused_bit_for_bit():
    a, b = _port_system("fused"), _port_system("modular")
    ra, rb = a.run_windows(4), b.run_windows(4)
    assert _strip(ra) == _strip(rb)
    ea, eb = a.export_replay("s"), b.export_replay("s")
    for key in ("obs", "actions", "rewards", "next_obs", "tick_idx",
                "valid", "times"):
        assert np.array_equal(ea[key], eb[key]), key
    sa, sb = a.snapshot_state(), b.snapshot_state()
    assert torch.equal(sa.norm.mean, sb.norm.mean)
    assert torch.equal(sa.prev_ts, sb.prev_ts)
    assert b.pipeline.mode == "modular"


def test_modular_matches_jax_system():
    """The reference's ``test_system_fused_equals_modular`` system (linear
    policy), in ``modular`` mode in both packages."""
    cfg_kw = dict(n_envs=3, n_streams=3, n_ticks=8, tick_s=60.0,
                  max_samples=32)
    jmodel = jax_linear(3, 2)
    jpred = JaxPredictor(jmodel, jax_energy(price_idx=1, grid_idx=0,
                                            temp_idx=2),
                         JaxSpace(np.array([-1., -1.]), np.array([1., 1.])),
                         3, 3, replay_capacity=64)
    envs = [f"bldg-{i}" for i in range(3)]
    jsys = JaxSystem(envs, _sources(JaxSource, JaxDevice),
                     JaxConfig(**cfg_kw), jpred, speedup=5000.0,
                     manual_time=True, mode="modular")
    params = convert.policy_params_from_numpy(
        "linear", {"w": np.asarray(jmodel.params["w"])})
    pred = Predictor(linear_builder(3, 2, params=params, device="cpu"),
                     energy_reward_spec(1, 0, 2),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     3, 3, replay_capacity=64, device="cpu")
    psys = PerceptaSystem(envs, _sources(SourceSpec, SimulatedDevice),
                          PipelineConfig(**cfg_kw), pred, speedup=5000.0,
                          manual_time=True, mode="modular", device="cpu")
    want, got = jsys.run_windows(3), psys.run_windows(3)
    for w, g in zip(want, got):
        assert abs(w["mean_reward"] - g["mean_reward"]) < 1e-3
        assert abs(w["observed_frac"] - g["observed_frac"]) < 1e-9
        assert_allclose(g["mean_reward"], w["mean_reward"], **TOL)
        for key in ("window", "records", "observed_frac", "filled_frac",
                    "anomalous"):
            assert g[key] == w[key], key
    assert int(psys.predictor.replay.size()) == 2


@pytest.mark.parametrize("elastic", [False, True], ids=["dense", "elastic"])
def test_batched_consume_false_equals_true(elastic):
    """The per-window ``on_tick`` consume equals the batched one bit for
    bit (results, replay, the model carry), the elastic masks included."""
    kw = dict(elastic=True, env_slots=6) if elastic else {}
    n = 6 if elastic else 4
    systems = []
    for batched in (True, False):
        s = _port_system("scan", n_envs=n, batched_consume=batched, **kw)
        if elastic:
            for e in ("bldg-4", "bldg-5"):   # two free slots from the start
                s.detach_env(e)
        systems.append((s, s.run_windows(4)))
        if elastic:
            s.attach_env("late")
            systems[-1] = (s, systems[-1][1] + s.run_windows(5))
    (a, ra), (b, rb) = systems
    assert not b.batched_consume
    assert _strip(ra) == _strip(rb)
    ea, eb = a.export_replay("s"), b.export_replay("s")
    assert ea["env_ids"] == eb["env_ids"]
    for key in ("obs", "actions", "rewards", "next_obs", "tick_idx",
                "valid", "times"):
        assert np.array_equal(ea[key], eb[key]), key
    assert torch.equal(a.predictor._model_carry["h"],
                       b.predictor._model_carry["h"])


def test_batched_consume_false_matches_jax():
    """``batched_consume=False`` in both packages (linear policy): the
    per-window results and the replay under the parity policy."""
    cfg_kw = dict(n_envs=3, n_streams=3, n_ticks=8, tick_s=60.0,
                  max_samples=32, gap_strategy="locf", feature_agg="mean")
    jmodel = jax_linear(3, 2)
    space = (np.array([-1., -1.]), np.array([1., 1.]))
    jpred = JaxPredictor(jmodel, jax_energy(1, 0, 2), JaxSpace(*space), 3,
                         3, replay_capacity=16)
    envs = [f"bldg-{i}" for i in range(3)]
    jsys = JaxSystem(envs, _sources(JaxSource, JaxDevice),
                     JaxConfig(**cfg_kw), jpred, speedup=5000.0,
                     manual_time=True, mode="scan", scan_k=3,
                     batched_consume=False)
    params = convert.policy_params_from_numpy(
        "linear", {"w": np.asarray(jmodel.params["w"])})
    pred = Predictor(linear_builder(3, 2, params=params, device="cpu"),
                     energy_reward_spec(1, 0, 2), ActionSpace(*space), 3, 3,
                     replay_capacity=16, device="cpu")
    psys = PerceptaSystem(envs, _sources(SourceSpec, SimulatedDevice),
                          PipelineConfig(**cfg_kw), pred, speedup=5000.0,
                          manual_time=True, mode="scan", scan_k=3,
                          batched_consume=False, device="cpu")
    want, got = jsys.run_windows(7), psys.run_windows(7)
    for w, g in zip(want, got):
        assert_allclose(g["mean_reward"], w["mean_reward"], **TOL)
        for key in ("window", "records", "observed_frac", "filled_frac",
                    "anomalous"):
            assert g[key] == w[key], key
    wexp, gexp = jsys.export_replay("s"), psys.export_replay("s")
    for key in ("tick_idx", "valid", "times"):
        assert np.array_equal(gexp[key], wexp[key]), key
    for key in ("obs", "actions", "rewards", "next_obs"):
        assert_allclose(gexp[key], wexp[key], **TOL)
    assert psys.replay_size() == jsys.replay_size() == 6
