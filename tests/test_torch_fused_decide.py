"""The port's fused decision path (``mode="scan_fused_decide"``) against
the JAX package and against the port's own two-launch ``scan`` path.

``replay.add_batch`` against the JAX ``add_batch`` and against sequential
``add`` calls; ``core.pipeline.run_many_decide`` against the JAX function
from the same carry (``convert.decide_state_from_numpy``) and against
``run_many`` + ``Predictor.on_windows`` within the port; the system across
``scan_k`` splits, ring wraparound, long horizons, pre-system predictor
history, snapshots and guards.

Tolerances: masks, counts, ``tick_idx``, ``version``, ``valid``, the
cursor, ``times`` and ``policy_version`` exactly; floats against JAX at
rtol = atol = 1e-4 (``tests/test_torch_system.py``'s ``TOL``: XLA and
torch round transcendental functions and sums differently); within the
port everything bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import PipelineConfig as JaxConfig
from repro.core import pipeline as jpl
from repro.core import replay as jrp
from repro.core.frame import make_raw_window as jax_raw_window
from repro.core.reward import energy_reward_spec as jax_energy
from repro.runtime import policies as jpol
from repro.runtime import predictor as jpred
from repro_torch import convert
from repro_torch.core import PipelineConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import replay as rp
from repro_torch.core.frame import make_raw_window
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime import policies as pol
from repro_torch.runtime.db import LogDB
from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

TOL = dict(rtol=1e-4, atol=1e-4)
T_ = lambda x: torch.from_numpy(np.array(x))   # a writable private copy
SPACE = (np.array([-1.0, -0.5]), np.array([1.0, 0.5]))
T0_FAR = float(2 ** 24)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- add_batch
@pytest.mark.parametrize("row0", [True, False], ids=["row0", "row0-masked"])
@pytest.mark.parametrize("C", [4, 16])
@pytest.mark.parametrize("K", [1, 3, 8, 20])
def test_add_batch_matches_jax_and_sequential_adds(K, C, row0, rng):
    """One write per leaf == K guarded sequential ``add`` calls == the JAX
    ``add_batch``, bit for bit: masked rows, the cursor, K > capacity; and
    a second batch from mid-ring."""
    E, F, A = 3, 4, 2
    ring = [(rp.init(E, C, F, A), jrp.init(E, C, F, A), rp.init(E, C, F, A))]
    seq, want, got = ring[0]
    for b in range(2):
        obs = rng.normal(0, 1, (K, E, F)).astype(np.float32)
        act = rng.normal(0, 1, (K, E, A)).astype(np.float32)
        rew = rng.normal(0, 1, (K, E)).astype(np.float32)
        nxt = rng.normal(0, 1, (K, E, F)).astype(np.float32)
        idx = np.arange(b * K, (b + 1) * K, dtype=np.int32)
        ver = (np.arange(K) % 3).astype(np.int32)
        mask = rng.rand(K) > 0.3
        mask[0] = row0
        for j in range(K):
            if mask[j]:
                rp.add(seq, T_(obs[j]), T_(act[j]), T_(rew[j]), T_(nxt[j]),
                       T_(idx[j]), T_(ver[j]))
        want = jrp.add_batch(want, *map(jnp.asarray, (obs, act, rew, nxt,
                                                      idx, mask, ver)))
        out = rp.add_batch(got, *map(T_, (obs, act, rew, nxt, idx, mask,
                                          ver)))
        assert out is got                       # written in place
    for s, w, g in zip(seq, want, got):
        assert g.dtype == s.dtype
        assert torch.equal(g, s)
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got.cursor.dtype == torch.int32


@pytest.mark.parametrize("C", [4, 16])
@pytest.mark.parametrize("K", [1, 3, 20])
def test_add_batch_env_mask_matches_jax(K, C, rng):
    """The elastic row liveness (``env_mask`` (K, E)) lands in ``valid``
    only, equal to the JAX ``add_batch`` and to K guarded sequential
    ``add`` calls with the per-window mask, bit for bit: ring positions
    and every other leaf as without it, K > capacity included."""
    E, F, A = 4, 3, 2
    seq, got, want = rp.init(E, C, F, A), rp.init(E, C, F, A), \
        jrp.init(E, C, F, A)
    obs = rng.normal(0, 1, (K, E, F)).astype(np.float32)
    act = rng.normal(0, 1, (K, E, A)).astype(np.float32)
    rew = rng.normal(0, 1, (K, E)).astype(np.float32)
    nxt = rng.normal(0, 1, (K, E, F)).astype(np.float32)
    idx = np.arange(K, dtype=np.int32)
    ver = np.zeros(K, np.int32)
    mask = rng.rand(K) > 0.2
    env_mask = rng.rand(K, E) > 0.4
    env_mask[:, 1] = False                   # a free slot
    for j in range(K):
        if mask[j]:
            rp.add(seq, T_(obs[j]), T_(act[j]), T_(rew[j]), T_(nxt[j]),
                   T_(idx[j]), T_(ver[j]), env_mask=T_(env_mask[j]))
    want = jrp.add_batch(want, *map(jnp.asarray, (obs, act, rew, nxt, idx,
                                                  mask, ver)),
                         env_mask=jnp.asarray(env_mask))
    rp.add_batch(got, *map(T_, (obs, act, rew, nxt, idx, mask, ver)),
                 env_mask=T_(env_mask))
    for s, w, g in zip(seq, want, got):
        assert torch.equal(g, s)
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not got.valid[1].any()


# ------------------------------------------------------- run_many_decide
E, S, M, T, F, A = 3, 3, 16, 8, 3, 2
PCFG = dict(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0, max_samples=M,
            gap_strategy="locf", feature_agg="mean", k_sigma=4.0)


def _raws(rng, K):
    return (rng.normal(5, 2, (K, E, S, M)).astype(np.float32),
            rng.uniform(0, T * 60, (K, E, S, M)).astype(np.float32),
            rng.rand(K, E, S, M) > 0.3)


def _jax_model(policy):
    if policy == "linear":
        return jpred.linear_policy(F, A, seed=3)
    return jpol.rglru_builder(F, A, n_envs=E, hidden=8, seed=3)


def _port_predictor(policy, jmodel, capacity):
    params = convert.policy_params_from_numpy(policy, _np(jmodel.params))
    kw = {"hidden": 8, "use_kernel": True} if policy == "rglru" else {}
    model = pol.build_policy(pol.PolicyConfig(policy, kw), F, A, E,
                             params=params, device="cpu")
    return Predictor(model, energy_reward_spec(1, 0, 2), ActionSpace(*SPACE),
                     E, F, replay_capacity=capacity, device="cpu")


@pytest.mark.parametrize("policy", ["linear", "rglru"])
def test_run_many_decide_matches_jax_from_a_carried_state(policy, rng):
    """The JAX engine runs batch 1; its pipeline state and decide carry go
    across (``convert``); both run batch 2, which wraps the ring."""
    K, C = 6, 8
    jcfg, cfg = JaxConfig(**PCFG), PipelineConfig(use_kernel=True, **PCFG)
    jmodel = _jax_model(policy)
    jp = jpred.Predictor(jmodel, jax_energy(1, 0, 2), jpred.ActionSpace(
        *SPACE), E, F, replay_capacity=C)
    engine = jax.jit(functools.partial(jpl.run_many_decide, jcfg,
                                       jp.make_decide_fn()))
    starts = np.zeros((K, E), np.float32)
    state, dstate, _ = engine(jpl.init_state(jcfg), jp.decide_state(),
                              jax_raw_window(*_raws(rng, K)), starts)
    batch2 = _raws(rng, K)
    pstate = convert.pipeline_state_from_numpy(_np(state))
    pdstate = convert.decide_state_from_numpy(_np(dstate))
    assert int(pdstate.tick) == K and bool(pdstate.have_prev)
    want_s, want_d, want = engine(state, dstate, jax_raw_window(*batch2),
                                  starts)
    pp = _port_predictor(policy, jmodel, C)
    got_s, got_d, got = pl.run_many_decide(
        cfg, pp.make_decide_fn(), pstate, pdstate, make_raw_window(*batch2),
        T_(starts))
    for key in ("violated", "observed", "filled", "anomalous"):
        g, w = getattr(got, key).numpy(), np.asarray(getattr(want, key))
        assert g.dtype == w.dtype and np.array_equal(g, w), key
    for key in ("actions", "rewards", "per_term", "features"):
        assert_allclose(getattr(got, key).numpy(),
                        np.asarray(getattr(want, key)), **TOL)
    assert int(got_d.tick) == int(want_d.tick) == 2 * K
    assert int(got_d.replay.cursor) == int(want_d.replay.cursor) == 2 * K - 1
    for key in ("tick_idx", "version", "valid"):
        assert np.array_equal(getattr(got_d.replay, key).numpy(),
                              np.asarray(getattr(want_d.replay, key))), key
    for key in ("obs", "actions", "rewards", "next_obs"):
        assert_allclose(getattr(got_d.replay, key).numpy(),
                        np.asarray(getattr(want_d.replay, key)), **TOL)
    assert_allclose(got_d.prev_actions.numpy(),
                    np.asarray(want_d.prev_actions), **TOL)
    if policy == "rglru":
        assert_allclose(got_d.carry["h"].numpy(),
                        np.asarray(want_d.carry["h"]), **TOL)
    assert_allclose(got_s.norm.mean.numpy(), np.asarray(want_s.norm.mean),
                    **TOL)


@pytest.mark.parametrize("policy", ["linear", "rglru"])
def test_run_many_decide_equals_run_many_and_on_windows(policy, rng):
    """Within the port, the fused loop equals the two-launch path bit for
    bit across two batches (the prev chain and the ring cross them)."""
    K, C = 5, 8
    cfg = PipelineConfig(use_kernel=True, **PCFG)
    jmodel = _jax_model(policy)
    ref, fus = (_port_predictor(policy, jmodel, C) for _ in range(2))
    pipe = pl.PerceptaPipeline(cfg, mode="scan", device="cpu")
    fpipe = pl.PerceptaPipeline(cfg, mode="scan_fused_decide", device="cpu",
                                decide=fus.make_decide_fn())
    state, fstate = pipe.init_state(), fpipe.init_state()
    dstate = fus.decide_state()
    starts = torch.zeros((K, E))
    for b in range(2):
        raws = make_raw_window(*_raws(rng, K))
        state, feats, frames = pipe.run_many(state, raws, starts)
        times = [480.0 * (b * K + j + 1) for j in range(K)]
        acts, rews, per = ref.on_windows(feats.features, times,
                                         raw=feats.raw)
        fstate, dstate, outs = fpipe.run_many_decide(fstate, dstate, raws,
                                                     starts)
        fus.absorb_fused(times, outs.violated.numpy())
        assert np.array_equal(outs.actions.numpy(), acts)
        assert np.array_equal(outs.rewards.numpy(), rews)
        assert np.array_equal(outs.per_term.numpy(), per)
        assert torch.equal(outs.features, feats.features)
        for key in ("observed", "filled", "anomalous"):
            assert torch.equal(getattr(outs, key),
                               getattr(frames, key).sum(dim=(2, 3)).int())
    for x, y in zip(ref.replay, dstate.replay):
        assert torch.equal(x, y)
    assert dstate.replay.cursor is fus.replay.cursor   # the same ring
    assert ref.stats == fus.stats
    assert np.array_equal(ref._replay_times, fus._replay_times)
    if policy == "rglru":
        assert torch.equal(ref._model_carry["h"], dstate.carry["h"])
    with pytest.raises(RuntimeError, match="run_many_decide"):
        fpipe.run_many(fstate, raws, starts)
    with pytest.raises(RuntimeError, match="scan_fused_decide"):
        pipe.run_many_decide(state, dstate, raws, starts)


def test_fused_pipeline_needs_decide():
    cfg = PipelineConfig(**PCFG)
    with pytest.raises(ValueError, match="decide="):
        pl.PerceptaPipeline(cfg, mode="scan_fused_decide", device="cpu")


# ------------------------------------------------------------------ system
def _system(mode, scan_k=3, cap=16, db=None, t0=0.0, tick_s=60.0,
            forwarders=True, predictor=None):
    srcs = [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
    ]
    cfg = PipelineConfig(n_envs=2, n_streams=2, n_ticks=8, tick_s=tick_s,
                         max_samples=32, feature_agg="mean", use_kernel=True)
    pred = predictor or Predictor(
        pol.PolicyConfig("rglru", {"hidden": 8, "use_kernel": True}),
        energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0),
        ActionSpace(np.array([-1., -1.]), np.array([1., 1.])), 2,
        cfg.n_features, replay_capacity=cap, device="cpu")
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev", "amqp", [1])]) if forwarders else None
    return PerceptaSystem(["bldg-0", "bldg-1"], srcs, cfg, pred,
                          forwarders=hub,
                          db=None if db is None else LogDB(db, salt="x"),
                          manual_time=True, mode=mode, scan_k=scan_k, t0=t0,
                          device="cpu")


def _strip(results, drop=("latency_s",)):
    return [{k: v for k, v in r.items() if k not in drop} for r in results]


def _rows(db):
    return [{k: v for k, v in row.items() if k != "logged_at"}
            for _, row in db.read_from()]


def _assert_export_equal(a, b):
    assert a["env_ids"] == b["env_ids"]
    for key in a:
        if key != "env_ids":
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("mode", ["scan_fused_decide",
                                  "scan_fused_decide_async"])
def test_fused_system_equals_scan(mode, tmp_path):
    """7 windows over scan_k = 3 (two batches and a ragged one): results,
    forwarder sinks, DB rows, predictor stats and the export bit for bit."""
    ref = _system("scan", db=str(tmp_path / "ref"))
    fus = _system(mode, db=str(tmp_path / "fus"))
    rr, rf = ref.run_windows(7), fus.run_windows(7)
    assert _strip(rr) == _strip(rf)
    for fa, fb in zip(ref.forwarders.forwarders, fus.forwarders.forwarders):
        assert fa.sink == fb.sink and fa.stats == fb.stats
    assert _rows(ref.db) == _rows(fus.db) and len(_rows(fus.db)) == 14
    assert ref.predictor.stats == fus.predictor.stats
    _assert_export_equal(ref.export_replay("s"), fus.export_replay("s"))
    for s in (ref, fus):
        s.db.close()
        s.stop()


def test_fused_system_split_invariance():
    """21 windows as scan_k = 1, 3 and 8: the carry threads through every
    batch boundary; only the per-window record attribution follows the
    drain schedule (the totals agree). The receivers' backlog horizon
    covers two 8-window batches, so no drain loses samples."""
    outs, exports = [], []
    for k in (1, 3, 8):
        s = _system("scan_fused_decide", scan_k=k, cap=64, forwarders=False)
        for r in s.receivers:
            r.max_backlog_s = 2 * 8 * s.window_s
        outs.append(s.run_windows(21))
        exports.append(s.export_replay("s"))
        s.stop()
    norecs = [_strip(o, ("latency_s", "records")) for o in outs]
    assert norecs[0] == norecs[1] == norecs[2]
    assert len({sum(r["records"] for r in o) for o in outs}) == 1
    _assert_export_equal(exports[0], exports[1])
    _assert_export_equal(exports[0], exports[2])


def test_fused_system_ring_wraps_with_k_above_capacity(tmp_path):
    """scan_k = 7 on a 4-slot ring: one batch overwrites the whole ring."""
    ref = _system("scan", cap=4, scan_k=7, db=str(tmp_path / "ref"))
    fus = _system("scan_fused_decide", cap=4, scan_k=7,
                  db=str(tmp_path / "fus"))
    assert _strip(ref.run_windows(11)) == _strip(fus.run_windows(11))
    assert _rows(ref.db) == _rows(fus.db)
    ea, eb = ref.export_replay("s"), fus.export_replay("s")
    _assert_export_equal(ea, eb)
    # 11 ticks -> 10 transitions through 4 slots: the last 4, in order
    assert np.array_equal(eb["tick_idx"][0], np.arange(7, 11))
    assert (np.diff(eb["times"][0]) > 0).all()
    assert ref.replay_size() == fus.replay_size() == 4
    for s in (ref, fus):
        s.db.close()
        s.stop()


def test_fused_export_exact_at_long_horizon():
    """t0 = 2^24 s with 0.8 s windows: float32 would merge window ends; the
    fused export carries the exact float64 ends, equal to the scan path's
    host mirror bit for bit."""
    ref = _system("scan", t0=T0_FAR, tick_s=0.1, forwarders=False)
    fus = _system("scan_fused_decide", t0=T0_FAR, tick_s=0.1,
                  forwarders=False)
    assert _strip(ref.run_windows(6, pump=False)) == \
        _strip(fus.run_windows(6, pump=False))
    ends = np.asarray([ref.window_bounds(j)[1] for j in range(6)])
    assert len(np.unique(ends.astype(np.float32))) < 6     # premise
    ea, eb = ref.export_replay("s"), fus.export_replay("s")
    _assert_export_equal(ea, eb)
    assert np.array_equal(eb["times"][0], ends[1:])
    ref.stop()
    fus.stop()


def test_fused_export_with_pre_system_predictor_history(rng):
    """A Predictor that consumed windows before the system existed keeps
    its mirror times for those slots, and the fused system's batches
    extend the same mirror from its tick count on."""
    feats = rng.normal(0, 1, (3, 2, 2)).astype(np.float32)
    systems = []
    for mode in ("scan", "scan_fused_decide"):
        pred = Predictor(
            pol.PolicyConfig("rglru", {"hidden": 8, "use_kernel": True}),
            energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0),
            ActionSpace(np.array([-1., -1.]), np.array([1., 1.])), 2, 2,
            replay_capacity=16, device="cpu")
        pred.on_windows(T_(feats), [7.5, 11.25, 200.0])
        systems.append(_system(mode, predictor=pred, forwarders=False))
    ref, fus = systems
    assert fus.predictor.stats["ticks"] == 3
    assert _strip(ref.run_windows(5)) == _strip(fus.run_windows(5))
    ea, eb = ref.export_replay("s"), fus.export_replay("s")
    _assert_export_equal(ea, eb)
    assert eb["tick_idx"][0].min() < 3 <= eb["tick_idx"][0].max()
    assert 11.25 in eb["times"][0] and 200.0 in eb["times"][0]
    ref.stop()
    fus.stop()


def test_snapshot_decide_is_isolated_from_later_batches():
    """The live ring is written in place, so a snapshot must be a copy: one
    taken before a batch holds its values after it."""
    s = _system("scan_fused_decide", forwarders=False)
    s.run_windows(4)
    snap = s.snapshot_decide()
    frozen = [x.clone() for x in snap.replay] + [snap.tick.clone(),
                                                 snap.carry["h"].clone()]
    norm = s.snapshot_norm()
    norm_frozen = [x.clone() for x in norm]
    s.run_windows(3)
    live = s.snapshot_decide()
    for x, y in zip(list(snap.replay) + [snap.tick, snap.carry["h"]],
                    frozen):
        assert torch.equal(x, y)
    assert not torch.equal(live.replay.obs, snap.replay.obs)
    assert int(snap.tick) == 4 and int(live.tick) == 7
    assert all(torch.equal(x, y) for x, y in zip(norm, norm_frozen))
    assert not torch.equal(s.state.norm.mean, norm.mean)
    assert s.replay_size() == 6           # 7 ticks -> 6 transitions
    s.stop()


def test_fused_accessors_and_guards():
    s = _system("scan_fused_decide", forwarders=False)
    ref = _system("scan", forwarders=False)
    for sys_ in (s, ref):
        sys_.run_windows(2)
        assert sys_.policy_version() == 0
        assert sys_.replay_size() == 1
    with pytest.raises(RuntimeError, match="run_many_decide"):
        s.pipeline.run_many(s.state, None, None)
    with pytest.raises(ValueError, match="not a fused-decide mode"):
        ref.snapshot_decide()
    # the ring the carry writes is the Predictor's own (same storage)
    assert s._dstate.replay.obs is s.predictor.replay.obs
    s.stop()
    ref.stop()
