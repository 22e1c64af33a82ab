"""Elastic env-slot pools in the port (``PerceptaSystem(elastic=True)``),
case for case with ``tests/test_elastic.py``, plus the pieces under them.

Each system case runs within the port, where a live env's rows must equal
a dense fixed-E system's bit for bit (results, replay export), and the
same schedule runs through the JAX system in the same process (the
simulated readings hash Python strings), where the port's rows must equal
JAX's under the parity policy: masks, counts, ``valid``, ``tick_idx``,
``times``, the cursor and the exported ids exactly; floats at rtol = atol
= 1e-4 (``tests/test_torch_system.py``'s ``TOL``). The 8-device mesh case
of the reference waits for the multi-device slice.

The pieces: ``distribution.elastic.grow_env_tree`` / ``reset_env_rows`` on
the port's trees against the JAX functions (exact: copies and selects),
``replay.add`` / ``add_many`` with ``env_mask`` (exact),
``core.pipeline.mask_env_rows`` (exact), ``convert.decide_state_from_numpy``
on a JAX elastic carry, the membership tag of the async modes, and
``train="online"`` through attach, detach and resize.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import PipelineConfig as JaxConfig
from repro.core import pipeline as jpl
from repro.core import replay as jrp
from repro.core.reward import energy_reward_spec as jax_energy
from repro.distribution import elastic as jel
from repro.runtime.predictor import ActionSpace as JaxSpace
from repro.runtime.predictor import Predictor as JaxPredictor
from repro.runtime.predictor import linear_policy as jax_linear
from repro.runtime.receivers import SimulatedDevice as JaxDevice
from repro.runtime.system import PerceptaSystem as JaxSystem
from repro.runtime.system import SourceSpec as JaxSource
from repro_torch import convert
from repro_torch.core import PipelineConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import replay as rp
from repro_torch.core.frame import FeatureFrame
from repro_torch.core.reward import energy_reward_spec
from repro_torch.distribution import elastic as el
from repro_torch.runtime.policies import linear_builder
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

TOL = dict(rtol=1e-4, atol=1e-4)
T_ = lambda x: torch.from_numpy(np.array(x))
ELASTIC_MODES = ("scan", "scan_async", "scan_fused_decide",
                 "scan_fused_decide_async")
STABLE = ["s0", "s1", "s2"]      # attached at construction, never touched
EXPORT_EXACT = ("tick_idx", "times", "valid", "version")
EXPORT_FLOAT = ("obs", "actions", "rewards", "next_obs")
SPACE = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
# the reference's linear policy at seed 0; the port loads its weights
JAX_W = np.asarray(jax_linear(2, 2).params["w"])


def _sources(spec, device):
    # off-tick reading intervals (9.7 / 31.3 s), as tests/test_elastic.py
    return [spec("grid_kw", "mqtt", device("grid", 9.7, base=3.0, seed=1)),
            spec("price_eur", "http", device("price", 31.3, base=0.2,
                                             seed=2))]


def _cfg_kw(n):
    return dict(n_envs=n, n_streams=2, n_ticks=8, tick_s=60.0,
                max_samples=32)


def _mk(env_ids, slots=None, elastic=False, mode="scan", scan_k=3, cap=16,
        **kw):
    """The port's twin of ``tests/test_elastic.py::_mk``."""
    n = slots if slots is not None else len(env_ids)
    cfg = PipelineConfig(**_cfg_kw(n))
    pred = Predictor(linear_builder(cfg.n_features, 2,
                                    params={"w": T_(JAX_W)}, device="cpu"),
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0),
                     ActionSpace(*SPACE), n, cfg.n_features,
                     replay_capacity=cap, device="cpu")
    return PerceptaSystem(list(env_ids), _sources(SourceSpec,
                                                  SimulatedDevice),
                          cfg, pred, speedup=5000.0, manual_time=True,
                          mode=mode, scan_k=scan_k, env_slots=slots,
                          elastic=elastic, device="cpu", **kw)


def _mk_jax(env_ids, slots=None, elastic=False, mode="scan", scan_k=3,
            cap=16):
    n = slots if slots is not None else len(env_ids)
    cfg = JaxConfig(**_cfg_kw(n))
    pred = JaxPredictor(jax_linear(cfg.n_features, 2),
                        jax_energy(price_idx=1, grid_idx=0, temp_idx=0),
                        JaxSpace(*SPACE), n, cfg.n_features,
                        replay_capacity=cap)
    return JaxSystem(list(env_ids), _sources(JaxSource, JaxDevice), cfg,
                     pred, speedup=5000.0, manual_time=True, mode=mode,
                     scan_k=scan_k, env_slots=slots, elastic=elastic)


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


def _assert_results_match_jax(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in w:
            if key == "mean_reward":
                assert_allclose(g[key], w[key], **TOL)
            elif key != "latency_s":
                assert g[key] == w[key], key


def _assert_rows_equal(dense_export, elastic_export):
    """Every env of the dense export has bit-identical replay rows in the
    elastic one, joined on the exported (salted) id."""
    ea = {e: i for i, e in enumerate(elastic_export["env_ids"])}
    for i, env in enumerate(dense_export["env_ids"]):
        assert env in ea, env
        j = ea[env]
        for k in EXPORT_FLOAT + EXPORT_EXACT:
            a = np.asarray(dense_export[k])[i]
            b = np.asarray(elastic_export[k])[j]
            assert a.dtype == b.dtype and np.array_equal(a, b), (env, k)


def _assert_export_matches_jax(got, want):
    """The port's whole export against JAX's, slot for slot."""
    assert got["env_ids"] == want["env_ids"]
    for k in EXPORT_EXACT:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    for k in EXPORT_FLOAT:
        assert_allclose(got[k], np.asarray(want[k]), **TOL)


# --------------------------------------------------------------------------
# Static subset: live rows of a part-full pool == a dense fixed-E system
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ELASTIC_MODES)
def test_elastic_static_subset_matches_dense(mode):
    """3 live envs in a 4-slot pool against a dense E = 3 ``scan`` system:
    the per-window results and the banked replay rows bit for bit (16
    windows over scan_k = 3, a ragged tail included); and against the JAX
    elastic system in the same mode."""
    dense = _mk(STABLE)
    elas = _mk(STABLE, slots=4, elastic=True, mode=mode)
    jel_ = _mk_jax(STABLE, slots=4, elastic=True, mode=mode)
    rd, re_, rj = (s.run_windows(16) for s in (dense, elas, jel_))
    assert _strip(rd) == _strip(re_)
    _assert_results_match_jax(re_, rj)
    ed, ee = dense.export_replay("s"), elas.export_replay("s")
    assert ee["env_ids"][:3] == ed["env_ids"] and len(ee["env_ids"]) == 4
    _assert_rows_equal(ed, ee)
    assert not ee["valid"][3].any()
    _assert_export_matches_jax(ee, jel_.export_replay("s"))
    assert elas.replay_size() == jel_.replay_size() == 15
    for s in (dense, elas, jel_):
        s.stop()


# --------------------------------------------------------------------------
# Membership plumbing: guards, slot recycling, fresh rows on reattach
# --------------------------------------------------------------------------

def test_membership_guards():
    elas = _mk(STABLE, slots=4, elastic=True, mode="scan_fused_decide")
    with pytest.raises(ValueError, match="already attached"):
        elas.attach_env("s0")
    with pytest.raises(ValueError, match="not attached"):
        elas.detach_env("ghost")
    elas.stop()
    dense = _mk(STABLE)
    with pytest.raises(ValueError, match="elastic=True"):
        dense.attach_env("s3")
    with pytest.raises(ValueError, match="elastic=True"):
        dense.resize()
    dense.stop()
    # the reference's refusal of a per-window engine, in both packages
    with pytest.raises(ValueError, match="scan engine"):
        _mk_jax(STABLE, slots=4, elastic=True, mode="fused")
    for mode in ("fused", "modular"):
        with pytest.raises(ValueError, match="scan engine"):
            _mk(STABLE, slots=4, elastic=True, mode=mode)
    with pytest.raises(ValueError, match="requires elastic=True"):
        _mk(STABLE, slots=4)
    with pytest.raises(ValueError, match="do not fit"):
        _mk(STABLE + ["s3", "s4"], slots=4, elastic=True)


def test_detach_reattach_recycles_slot_with_fresh_rows():
    """Detach then reattach the same env: it returns to the same slot, its
    old transitions are scrubbed, and it re-banks from a fresh prev chain:
    ``scan_k - 1`` transitions after one batch. Equal to JAX's."""
    out = []
    for mk in (_mk, _mk_jax):
        s = mk(STABLE, slots=4, elastic=True, mode="scan_fused_decide",
               scan_k=3, cap=64)
        s.run_windows(6)
        freed = s.detach_env("s1")
        assert s.env_ids == ["s0", "s2"]
        r = s.run_windows(3)
        got = s.attach_env("s1")
        assert got == freed
        assert s.env_ids == STABLE
        r += s.run_windows(3)
        valid = np.asarray(s.export_replay("s")["valid"])
        assert valid[1].sum() == 2
        assert valid[0].sum() == 11 and valid[2].sum() == 11
        out.append((r, s.export_replay("s")))
        s.stop()
    (rp_, ep), (rj, ej) = out
    _assert_results_match_jax(rp_, rj)
    _assert_export_matches_jax(ep, ej)


def test_detach_scrubs_the_slot_in_scan_mode():
    """``scan`` mode scrubs through ``Predictor.clear_env_rows``: a detached
    slot's ring cells are invalid, its prev and carry rows zero, and the
    next tenant re-banks K - 1 transitions after one batch."""
    s = _mk(STABLE, slots=4, elastic=True, mode="scan", cap=64)
    s.run_windows(6)
    slot = s.detach_env("s2")
    assert not s.predictor.replay.valid[slot].any()
    assert not s.predictor._prev["obs"][slot].any()
    assert s.predictor._prev["actions"][1].any()   # live rows untouched
    s.run_windows(3)
    assert s.attach_env("t0") == slot
    s.run_windows(3)
    assert np.asarray(s.export_replay("s")["valid"])[slot].sum() == 2
    s.stop()


def test_attach_env_grows_full_pool():
    """Attaching into a full pool grows it (4 -> 8 slots); the new env lands
    in the first slot of the padding; the JAX system does the same."""
    out = []
    for mk in (_mk, _mk_jax):
        s = mk(STABLE + ["c0"], slots=4, elastic=True,
               mode="scan_fused_decide")
        r = s.run_windows(3)
        assert s.env_slots == 4 and not s._free_slots
        slot = s.attach_env("c1")
        assert s.env_slots == 8 and slot == 4
        assert s.cfg.n_envs == 8 and s.predictor.n_envs == 8
        r += s.run_windows(3)
        assert all(np.isfinite(x["mean_reward"]) for x in r)
        out.append((r, s.export_replay("s")))
        s.stop()
    (rp_, ep), (rj, ej) = out
    _assert_results_match_jax(rp_, rj)
    _assert_export_matches_jax(ep, ej)


def test_resize_drops_the_staging_pool_and_keeps_the_ring_shared():
    s = _mk(STABLE, slots=4, elastic=True, mode="scan_fused_decide")
    s.run_windows(3)
    assert s._stage_pool
    s.resize()
    assert not s._stage_pool and s.env_slots == 8
    # the fused carry's ring is the Predictor's, grown once
    assert s._dstate.replay is s.predictor.replay
    assert s._dstate.replay.obs.shape[0] == 8
    assert s._dstate.active.shape == (8,) and not s._dstate.active[3:].any()
    with pytest.raises(ValueError, match="the pool has 8"):
        s.resize(8)
    s.run_windows(3)
    s.stop()


def test_async_membership_changes_only_at_batch_boundaries():
    """A plan in flight blocks attach/detach/resize; a batch assembled
    under an older membership epoch is refused at the handoff."""
    s = _mk(STABLE, slots=4, elastic=True, mode="scan_async")
    s.run_windows(3)
    s._prefetcher.submit([s.window_bounds()], pump=True,
                         membership=s._membership_epoch)
    assert s._prefetcher.in_flight() == 1
    with pytest.raises(RuntimeError, match="batch boundaries"):
        s.attach_env("c0")
    s._prefetcher.next_batch()
    s.window_index += 1
    assert s._prefetcher.in_flight() == 0
    s.attach_env("c0")
    s._prefetcher.submit([s.window_bounds()], pump=True, membership=0)
    batch = s._prefetcher.next_batch()
    assert batch.membership == 0 != s._membership_epoch
    s.stop()


# --------------------------------------------------------------------------
# Property: random churn schedules never perturb the stable envs' rows
# --------------------------------------------------------------------------

OP_NONE, OP_ATTACH, OP_DETACH, OP_RECYCLE, OP_RESIZE = range(5)


def _apply_schedule(mk, ops, mode, K):
    """``tests/test_elastic.py::_run_schedule``'s churn on a system built
    by ``mk``; returns it, its results and the windows run."""
    s = mk(STABLE, slots=4, elastic=True, mode=mode, scan_k=K, cap=4)
    churn, next_c = [], 0
    res = s.run_windows(K)
    for op in ops:
        if op == OP_ATTACH and next_c < 4:
            churn.append(f"c{next_c}")
            s.attach_env(churn[-1])
            next_c += 1
        elif op == OP_DETACH and churn:
            s.detach_env(churn.pop(0))
        elif op == OP_RECYCLE and churn:
            freed = s.detach_env(churn[0])
            assert s.attach_env(churn[0]) == freed
        elif op == OP_RESIZE and s.env_slots < 16:
            s.resize()
        res += s.run_windows(K)
    return s, res


def _run_schedule(ops, mode):
    """Attach/detach/recycle/regrow between K = 6 batches (capacity 4, so
    the ring wraps under a partial mask every batch); the stable envs'
    rows equal a dense never-churned port system bit for bit, and the
    whole pool equals the JAX system's under the same schedule."""
    K = 6
    elas, res = _apply_schedule(_mk, ops, mode, K)
    jsys, jres = _apply_schedule(_mk_jax, ops, mode, K)
    dense = _mk(STABLE, scan_k=K, cap=4)
    dense.run_windows(len(res))
    _assert_rows_equal(dense.export_replay("s"), elas.export_replay("s"))
    _assert_results_match_jax(res, jres)
    _assert_export_matches_jax(elas.export_replay("s"),
                               jsys.export_replay("s"))
    assert elas.env_slots == jsys.env_slots
    assert elas._free_slots == jsys._free_slots
    for s in (dense, elas, jsys):
        s.stop()


@pytest.mark.parametrize("ops", [
    (OP_ATTACH, OP_RECYCLE, OP_DETACH),    # fill, recycle a slot, free it
    (OP_ATTACH, OP_ATTACH, OP_ATTACH),     # 3rd attach fills -> auto-regrow
    (OP_RESIZE, OP_ATTACH, OP_RECYCLE),    # explicit regrow, churn after
])
@pytest.mark.parametrize("mode", ("scan", "scan_fused_decide"))
def test_elastic_churn_schedules_match_dense(ops, mode):
    _run_schedule(ops, mode)


# repro.testing hands out real hypothesis when installed and a
# deterministic drop-in otherwise, so this runs (never skips) everywhere
from repro.testing import given, settings, st  # noqa: E402


@given(ops=st.lists(st.integers(OP_NONE, OP_RESIZE),
                    min_size=2, max_size=3),
       mode=st.sampled_from(("scan", "scan_fused_decide")))
@settings(max_examples=8, deadline=None)
def test_elastic_random_schedule_matches_dense(ops, mode):
    _run_schedule(tuple(ops), mode)


# --------------------------------------------------------------------------
# Online training rides the elastic carry
# --------------------------------------------------------------------------

def test_online_training_through_churn():
    """``train="online"`` on an elastic pool: before the first applied
    step the results equal the untrained system's; a resize lands the
    pending step first; versions rise one per applied step."""
    kw = dict(slots=4, elastic=True, mode="scan_fused_decide", cap=32,
              policy="mlp")
    plain = _mk(STABLE, **kw)
    trained = _mk(STABLE, train="online", train_cfg={"batch_size": 16},
                  **kw)
    plain_r = plain.run_windows(3)
    r = trained.run_windows(3)
    assert _strip(r) == _strip(plain_r)            # nothing applied yet
    trained.attach_env("c0")                       # pool now full
    trained.run_windows(3)
    assert trained.train_stats()["dispatched"] == 2
    trained.attach_env("c1")                       # grows 4 -> 8
    assert trained.env_slots == 8 and trained.trainer._pending is None
    v = trained.policy_version()
    assert v == trained.train_stats()["applied"] >= 1
    trained.detach_env("s1")
    r = trained.run_windows(6)
    assert all(np.isfinite(x["mean_reward"]) for x in r)
    assert trained.policy_version() > v
    snap = trained.snapshot_decide()
    assert snap.active.tolist() == [True, False, True, True, True] \
        + [False] * 3
    for s in (plain, trained):
        s.stop()


# --------------------------------------------------------------------------
# The pieces: elastic trees, masked ring writes, masked outputs, convert
# --------------------------------------------------------------------------

def _numpy_tree(rng, E):
    """Env-leading leaves (float, bool) at E rows beside leaves without an
    env axis (a scalar cursor, a weight), as numpy arrays."""
    return {"gap": rng.normal(0, 1, (E, 3, 5)).astype(np.float32),
            "prev_ts": rng.normal(0, 1, (E, 3)).astype(np.float32),
            "valid": rng.rand(E, 7) > 0.5,
            "cursor": np.int32(9),
            "w": rng.normal(0, 1, (4, 2)).astype(np.float32)}


def test_grow_env_tree_matches_jax(rng):
    tree, tmpl = _numpy_tree(rng, 3), _numpy_tree(rng, 8)
    want = jel.grow_env_tree({k: jnp.asarray(v) for k, v in tree.items()},
                             {k: jnp.asarray(v) for k, v in tmpl.items()},
                             3)
    got = el.grow_env_tree({k: T_(v) for k, v in tree.items()},
                           {k: T_(v) for k, v in tmpl.items()}, 3)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert got[k].dtype == T_(tree[k]).dtype
    assert got["gap"].shape[0] == 8
    assert torch.equal(got["gap"][:3], T_(tree["gap"]))     # survivors
    assert torch.equal(got["gap"][3:], T_(tmpl["gap"])[3:])  # fresh rows
    bad = {k: T_(v) for k, v in tmpl.items()}
    bad["gap"] = torch.zeros((8, 3, 6))
    with pytest.raises(ValueError, match="does not match"):
        el.grow_env_tree({k: T_(v) for k, v in tree.items()}, bad, 3)
    # a pipeline state: the init sentinels arrive in the new rows
    cfg = PipelineConfig(**_cfg_kw(3))
    st = pl.init_state(cfg, "cpu")
    st = st._replace(prev_ts=torch.zeros_like(st.prev_ts))
    grown = el.grow_env_tree(st, pl.init_state(PipelineConfig(**_cfg_kw(5)), "cpu"),
                             3)
    assert grown.prev_ts[:3].eq(0).all() and grown.prev_ts[3:].eq(-1e30).all()
    assert torch.isinf(grown.norm.min[3:]).all()


def test_reset_env_rows_matches_jax(rng):
    tree, tmpl = _numpy_tree(rng, 6), _numpy_tree(rng, 6)
    for slots in ([], [4], [0, 5, 2]):
        want = jel.reset_env_rows(
            {k: jnp.asarray(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tmpl.items()}, slots)
        src = {k: T_(v) for k, v in tree.items()}
        got = el.reset_env_rows(src, {k: T_(v) for k, v in tmpl.items()},
                                slots)
        for k in tree:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
            assert np.array_equal(src[k].numpy(), tree[k]), k  # untouched


@pytest.mark.parametrize("n,cur,dev,want", [(3, 4, 1, 4), (5, 4, 1, 8),
                                            (9, 4, 1, 16), (5, 4, 3, 9),
                                            (1, 0, 1, 1)])
def test_next_pool_size_matches_jax(n, cur, dev, want):
    assert el.next_pool_size(n, cur, dev) == want == \
        jel.next_pool_size(n, cur, dev)


def test_add_and_add_many_env_mask_match_jax(rng):
    """``add`` / ``add_many`` with the (E,) / (K, E) row liveness against
    the JAX functions: ``valid`` takes the mask, every other leaf and the
    cursor are written as without it."""
    E, C, F, A, K = 4, 5, 3, 2, 7
    buf, jbuf = rp.init(E, C, F, A, "cpu"), jrp.init(E, C, F, A)
    xs = [rng.normal(0, 1, (K, E, F)).astype(np.float32),
          rng.normal(0, 1, (K, E, A)).astype(np.float32),
          rng.normal(0, 1, (K, E)).astype(np.float32),
          rng.normal(0, 1, (K, E, F)).astype(np.float32)]
    idx = np.arange(K, dtype=np.int32)
    env_mask = rng.rand(K, E) > 0.4
    jbuf = jrp.add(jbuf, *(jnp.asarray(x[0]) for x in xs), idx[0], 0,
                   env_mask=jnp.asarray(env_mask[0]))
    rp.add(buf, *(T_(x[0]) for x in xs), T_(idx[0]), 0,
           env_mask=T_(env_mask[0]))
    mask = np.ones(K - 1, bool)
    mask[2] = False
    ver = np.arange(K - 1, dtype=np.int32)
    jbuf = jrp.add_many(jbuf, *(jnp.asarray(x[1:]) for x in xs),
                        jnp.asarray(idx[1:]), jnp.asarray(mask),
                        jnp.asarray(ver), env_mask=jnp.asarray(env_mask[1:]))
    rp.add_many(buf, *(T_(x[1:]) for x in xs), T_(idx[1:]), mask, ver,
                env_mask=T_(env_mask[1:]))
    for g, w in zip(buf, jbuf):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not buf.valid.all() and buf.valid.any()


def test_mask_env_rows_matches_jax(rng):
    E = 5
    active = np.array([True, False, True, True, False])
    leaves = [rng.normal(0, 1, (E, 3)).astype(np.float32),
              rng.normal(0, 1, (E, 3)).astype(np.float32),
              rng.normal(0, 1, (E,)).astype(np.float32),
              rng.normal(0, 1, (E,)).astype(np.float32)]
    leaves[0][1, 0] = np.nan                   # garbage in a cold slot
    want = jpl.mask_env_rows(FeatureFrame(*map(jnp.asarray, leaves)),
                             jnp.asarray(active))
    got = pl.mask_env_rows(FeatureFrame(*map(T_, leaves)), T_(active))
    assert isinstance(got, FeatureFrame)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not torch.isnan(got.features).any()


def test_elastic_pipeline_asserts_its_mask():
    cfg = PipelineConfig(**_cfg_kw(3))
    pipe = pl.PerceptaPipeline(cfg, mode="scan", device="cpu", elastic=True)
    dense = pl.PerceptaPipeline(cfg, mode="scan", device="cpu")
    z = torch.zeros((1, 3, 2, 32))
    raws = pl.RawWindow(z, z, z.bool())
    starts = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="active"):
        pipe.run_many(pipe.init_state(), raws, starts)
    with pytest.raises(ValueError, match="active"):
        dense.run_many(dense.init_state(), raws, starts,
                       torch.ones(3, dtype=torch.bool))
    _, f, _ = pipe.run_many(pipe.init_state(), raws, starts,
                            torch.tensor([True, False, True]))
    assert f.features.shape == (1, 3, 2)


def test_decide_state_from_numpy_carries_the_elastic_masks():
    """A JAX elastic fused carry (after a batch with one detached slot)
    becomes the port's ``DecideState`` with its masks; the port's fused
    engine then continues it."""
    jsys = _mk_jax(STABLE, slots=4, elastic=True, mode="scan_fused_decide")
    jsys.run_windows(3)
    jsys.detach_env("s1")
    carry = jax.tree.map(np.asarray, jsys.snapshot_decide())
    d = convert.decide_state_from_numpy(carry)
    assert d.active.dtype == torch.bool and d.prev_ok.dtype == torch.bool
    assert d.active.tolist() == [True, False, True, False]
    assert d.prev_ok.tolist() == list(np.asarray(carry.prev_ok))
    assert np.array_equal(d.replay.valid.numpy(), carry.replay.valid)
    dense = convert.decide_state_from_numpy(
        jax.tree.map(np.asarray, _mk_jax(STABLE, mode="scan_fused_decide")
                     .snapshot_decide()))
    assert dense.active is None and dense.prev_ok is None
    jsys.stop()
