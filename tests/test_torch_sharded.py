"""Env sharding in the port: the ``*_sharded`` engines and system modes
against their unsharded twins on logical shards, and against the JAX
package.

Logical shards: ``sharding.visible_devices`` is replaced by N copies of
the CPU, so a mesh of N shards splits E = 12 rows into N trees that run
apart and gather back, exactly the code N cards would run. Within the
port every comparison is bit for bit: the engines' outputs, state and
carry (ring included), and the systems' results (all but ``latency_s``),
forwarder sinks, LogDB rows, replay export and ``snapshot_decide``; each
shard's replicated scalars must agree. Against the JAX system (its own
in-process one-device mesh) with the parity policy (the JAX rglru weights
through ``convert``): counts, ids, tick indices, versions, ``valid`` and
times exactly, floats at rtol = atol = 1e-4 (``test_torch_system.py``'s
bound: XLA and torch round transcendental functions differently).
"""
import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import PipelineConfig as JaxConfig
from repro.core.reward import energy_reward_spec as jax_energy
from repro.runtime import policies as jpol
from repro.runtime.db import LogDB as JaxLogDB
from repro.runtime.forwarder import Forwarder as JaxForwarder
from repro.runtime.forwarder import ForwarderHub as JaxHub
from repro.runtime.predictor import ActionSpace as JaxSpace
from repro.runtime.predictor import Predictor as JaxPredictor
from repro.runtime.receivers import SimulatedDevice as JaxDevice
from repro.runtime.system import PerceptaSystem as JaxSystem
from repro.runtime.system import SourceSpec as JaxSource
from repro_torch import convert
from repro_torch.core import PipelineConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.frame import make_raw_window
from repro_torch.core.reward import energy_reward_spec
from repro_torch.distribution import sharding as sh
from repro_torch.runtime.db import LogDB
from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
from repro_torch.runtime.policies import PolicyConfig, rglru_builder
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec
from repro_torch.train import tree

E = 12
NS = [1, 2, 3, 4, 6]
TOL = dict(rtol=1e-4, atol=1e-4)
SPACE = (np.array([-1.0, -0.5]), np.array([1.0, 0.5]))
PCFG = dict(n_streams=3, n_ticks=8, tick_s=60.0, max_samples=16,
            gap_strategy="locf", feature_agg="mean", k_sigma=4.0)
POLICIES = {"rglru": PolicyConfig("rglru", {"hidden": 8,
                                            "use_kernel": True}),
            "mlp": PolicyConfig("mlp", {"hidden": 8}),
            "linear": "linear"}
CPU = torch.device("cpu")


@pytest.fixture
def logical(monkeypatch):
    """``logical(n)``: the mesh sees n shards, all on the CPU."""
    def use(n):
        monkeypatch.setattr(sh, "visible_devices",
                            lambda device: [torch.device(device)] * n)
    return use


def _equal_trees(a, b, what):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, i)


# ------------------------------------------------------------------ engines
def _batch(rng, K, n_envs):
    S, M = PCFG["n_streams"], PCFG["max_samples"]
    window = PCFG["n_ticks"] * PCFG["tick_s"]
    vals = rng.normal(5, 2, (K, n_envs, S, M)).astype(np.float32)
    vals[rng.rand(*vals.shape) < 0.02] = 80.0          # spikes
    ts = rng.uniform(0, window, vals.shape).astype(np.float32)
    valid = rng.rand(*vals.shape) < 0.6
    valid[:, :, 1, :] &= rng.rand(K, n_envs, 1) < 0.5  # whole gaps
    return make_raw_window(vals, ts, valid)


def _predictor(policy, n=E, capacity=4):
    cfg = PipelineConfig(n_envs=n, use_kernel=True, **PCFG)
    return cfg, Predictor(POLICIES[policy], energy_reward_spec(1, 0, 2),
                          ActionSpace(*SPACE), n, cfg.n_features,
                          replay_capacity=capacity, device="cpu")


@pytest.mark.parametrize("elastic", [False, True], ids=["dense", "elastic"])
@pytest.mark.parametrize("n", NS)
def test_run_many_sharded_equals_unsharded(n, elastic, rng):
    """Two batches through ``make_run_many_sharded`` on n logical shards:
    features, frames and the gathered state equal ``run_many``'s bit for
    bit, and every shard carries the same ``tick_index``."""
    cfg = PipelineConfig(n_envs=E, use_kernel=True, **PCFG)
    mesh = sh.env_mesh(E, [CPU] * n)
    assert mesh.size == n
    fn, _ = pl.make_run_many_sharded(cfg, mesh, elastic=elastic)
    active = torch.from_numpy(rng.rand(E) < 0.7) if elastic else None
    state = pl.init_state(cfg)
    shards = sh.place_env_tree(state, 0, mesh)
    for _ in range(2):
        raws = _batch(rng, 3, E)
        starts = torch.zeros((3, E))
        state, f, fr = pl.run_many(cfg, state, raws, starts, active)
        shards, fs, frs = fn(shards, raws, starts, active)
        _equal_trees(f, fs, "features")
        _equal_trees(fr, frs, "frames")
    _equal_trees(state, sh.gather_env_tree(shards, 0), "state")
    assert sh.replicas_agree(shards, sh.env_specs(shards[0], 0))


@pytest.mark.parametrize("policy", ["rglru", "mlp", "linear"])
@pytest.mark.parametrize("n", NS)
def test_run_many_decide_sharded_equals_unsharded(n, policy, rng):
    """The fused engine on n logical shards: every ``DecideBatch`` leaf,
    the gathered state and decide carry (prev rows, model carry, ring,
    cursor) equal ``run_many_decide``'s bit for bit over three batches
    (the ring of 4 wraps); the policy leaves and scalars of every shard
    agree."""
    cfg, pred = _predictor(policy)
    decide = pred.make_decide_fn()
    mesh = sh.env_mesh(E, [CPU] * n)
    pipe = pl.PerceptaPipeline(cfg, "scan_fused_decide_sharded", device=CPU,
                               decide=decide, mesh=mesh)
    ref = pl.PerceptaPipeline(cfg, "scan_fused_decide", device=CPU,
                              decide=decide)
    dstate = pred.decide_state()
    shards = pipe.place_decide(tree.map_(lambda x: x.clone(), dstate))
    state, sstate = ref.init_state(), pipe.init_state()
    for _ in range(3):
        raws = _batch(rng, 3, E)
        starts = torch.zeros((3, E))
        with torch.no_grad():
            state, dstate, out = ref.run_many_decide(state, dstate, raws,
                                                     starts)
            sstate, shards, sout = pipe.run_many_decide(sstate, shards, raws,
                                                        starts)
        _equal_trees(out, sout, "DecideBatch")
    _equal_trees(state, pipe.gather_state(sstate), "state")
    _equal_trees(dstate, pipe.gather_decide(shards), "decide carry")
    assert sh.replicas_agree(shards, sh.decide_specs(shards[0], 0))


def test_place_and_gather_follow_the_rank_rule():
    """Leaves above ``env_axis`` split, scalars replicate (one copy per
    shard, never shared: the ring cursor is written in place), policy
    params replicate whatever their leading dim; gather inverts place."""
    cfg, pred = _predictor("linear", n=6)
    d = pred.decide_state()._replace(policy={"w": torch.ones(6, 2)})
    mesh = sh.env_mesh(6, [CPU] * 3)
    shards = sh.place_env_tree(d, 0, mesh, sh.decide_specs(d, 0))
    assert shards[1].prev_obs.shape[0] == 2
    assert shards[1].replay.obs.shape[:2] == (2, 4)
    assert shards[1].policy["w"].shape == (6, 2)      # replicated, not split
    assert shards[0].replay.cursor.data_ptr() != \
        shards[1].replay.cursor.data_ptr()
    assert shards[0].prev_obs.data_ptr() != d.prev_obs.data_ptr()
    _equal_trees(d, sh.gather_env_tree(shards, 0, sh.decide_specs(d, 0)),
                 "round trip")
    with pytest.raises(ValueError, match="does not split"):
        sh.place_env_tree(torch.zeros(5, 2), 0, mesh)
    assert sh.env_mesh(12, [CPU] * 5).size == 4       # largest divisor
    assert sh.env_mesh(7, [CPU] * 4).size == 1


def test_decide_state_on_mesh_converts_a_jax_carry():
    """``convert.decide_state_on_mesh``: a JAX elastic carry, placed on 3
    logical shards, gathers back to ``decide_state_from_numpy``'s tree."""
    from repro.core.reward import energy_reward_spec as jenergy
    jpred = JaxPredictor(jpol.build_policy("linear", 3, 2, 6),
                         jenergy(1, 0, 2), JaxSpace(*SPACE), 6, 3,
                         replay_capacity=4)
    jd = jpred.decide_state()._replace(
        active=np.array([1, 1, 0, 1, 0, 1], bool),
        prev_ok=np.array([1, 0, 0, 1, 0, 0], bool))
    jd = jax.tree.map(np.asarray, jd)
    mesh = sh.env_mesh(6, [CPU] * 3)
    shards = convert.decide_state_on_mesh(jd, mesh)
    whole = convert.decide_state_from_numpy(jd)
    assert len(shards) == 3 and shards[2].active.tolist() == [False, True]
    _equal_trees(whole, sh.gather_env_tree(
        shards, 0, sh.decide_specs(whole, 0)), "converted carry")


# ------------------------------------------------------------------ systems
def _sources(spec=SourceSpec, device=SimulatedDevice):
    return [
        spec("meter", "mqtt", device("grid_kw", 60.0, base=3.0, seed=1)),
        spec("price", "http", device("price_eur", 300.0, base=0.2,
                                     amplitude=0.05, seed=2)),
        spec("thermo", "amqp", device("temp_c", 30.0, base=21.0,
                                      amplitude=1.5, seed=3)),
    ]


def _system(mode, db_dir, policy, env_ids=None, slots=None, **kw):
    env_ids = env_ids or [f"bldg-{i}" for i in range(E)]
    n = slots or len(env_ids)
    cfg, pred = _predictor(policy, n)
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev-charger", "amqp", [1])])
    return PerceptaSystem(env_ids, _sources(), cfg, pred, forwarders=hub,
                          db=LogDB(str(db_dir), salt="s"), mode=mode,
                          manual_time=True, scan_k=3, device="cpu",
                          env_slots=slots, **kw)


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


def _record(system, results):
    rec = {"results": _strip(results),
           "sinks": [list(f.sink) for f in system.forwarders.forwarders],
           "db": [{k: v for k, v in r.items() if k != "logged_at"}
                  for _, r in system.db.read_from()],
           "export": system.export_replay("salt"),
           "size": system.replay_size()}
    if system.fused_decide:
        rec["decide"] = system.snapshot_decide()
        rec["policy"] = system.snapshot_policy()
    return rec


def _same_record(got, want):
    assert got["results"] == want["results"]
    assert got["sinks"] == want["sinks"]
    assert got["db"] == want["db"]
    assert got["size"] == want["size"]
    ga, wa = got["export"], want["export"]
    assert ga["env_ids"] == wa["env_ids"]
    for key in wa:
        if key != "env_ids":
            assert ga[key].dtype == wa[key].dtype
            assert np.array_equal(ga[key], wa[key]), key
    for key in ("decide", "policy"):
        if key in want:
            _equal_trees(got[key], want[key], key)


def _run(system, n_windows):
    try:
        return _record(system, system.run_windows(n_windows))
    finally:
        system.stop()
        system.db.close()


# each sharded mode, its twin and the policy it runs here
MODES = {"scan_sharded": ("scan", "rglru"),
         "scan_async_sharded": ("scan_async", "linear"),
         "scan_fused_decide_sharded": ("scan_fused_decide", "rglru"),
         "scan_fused_decide_async_sharded": ("scan_fused_decide_async",
                                             "mlp")}
_TWINS = {}


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", list(MODES))
def test_system_sharded_equals_unsharded_twin(mode, n, logical, tmp_path):
    """Each sharded mode on n logical shards against its unsharded twin
    over 7 windows (batches of 3, 3 and 1; the ring of 4 wraps): results,
    forwarder sinks, LogDB rows, the replay export and, in the fused
    modes, ``snapshot_decide`` and the live policy, bit for bit."""
    twin, policy = MODES[mode]
    if mode not in _TWINS:
        _TWINS[mode] = _run(_system(twin, tmp_path / "twin", policy), 7)
    logical(n)
    system = _system(mode, tmp_path / "sharded", policy)
    assert system.mesh.size == n
    if system.fused_decide:
        assert len(system._dstate) == n
        assert system.policy_certificate is not None
        assert {"env-reduce", "env-gemm-rows", "carry-env-mix"} <= \
            set(system.policy_certificate.rules) or policy != "rglru"
    _same_record(_run(system, 7), _TWINS[mode])


@pytest.mark.parametrize("n", [1, 3])
def test_predictor_ring_is_the_carrys_shard_rings(n, logical, tmp_path):
    """The ring has one rule in every fused mode: the Predictor's
    ``replay`` is the ring the carry writes. Sharded, that is the tuple of
    shard rings, so no whole-width ring stays behind to be read stale:
    the Predictor's own export and size follow the batches and equal the
    system's."""
    logical(n)
    system = _system("scan_fused_decide_sharded", tmp_path / "db", "rglru")
    rings = system.predictor.replay
    assert isinstance(rings, tuple) and len(rings) == n
    assert all(r is d.replay for r, d in zip(rings, system._dstate))
    system.run_windows(3)
    assert system.predictor.replay is rings
    assert int(rings[0].cursor) == system.replay_size() == 2
    got = system.predictor.export_replay(system.env_ids, "salt")
    want = system.export_replay("salt")
    assert got["env_ids"] == want["env_ids"]
    for key in want:
        if key != "env_ids":
            assert np.array_equal(got[key], want[key]), key
    assert got["valid"].any()
    system.stop()
    system.db.close()


@pytest.mark.parametrize("mode,policy", [
    ("scan_fused_decide_sharded", "rglru"), ("scan_sharded", "mlp")])
def test_elastic_churn_and_resize_across_a_mesh_split(mode, policy, logical,
                                                      tmp_path):
    """An elastic pool of 6 slots on 4 visible logical devices (a mesh of
    3 shards of 2 rows): batch; a building leaves; batch; two join (one
    recycles the slot, one fills the pool); a third grows the pool to 12
    slots, re-placed on a mesh of 4 shards of 3; two batches. Every batch's
    results, the sinks, DB rows, replay export and decide carry equal an
    unsharded pool's under the same schedule, bit for bit."""
    envs = [f"bldg-{i}" for i in range(5)]

    def drive(system):
        out = system.run_windows(3)
        system.detach_env("bldg-1")
        out += system.run_windows(3)
        slots = [system.attach_env("new-0"), system.attach_env("new-1")]
        slots.append(system.attach_env("new-2"))
        out += system.run_windows(6)
        return slots, out

    twin_mode = mode.replace("_sharded", "")
    ref = _system(twin_mode, tmp_path / "twin", policy, envs, slots=6,
                  elastic=True)
    ref_slots, ref_out = drive(ref)
    want = _record(ref, ref_out)
    ref.stop()
    logical(4)
    system = _system(mode, tmp_path / "sharded", policy, envs, slots=6,
                     elastic=True)
    assert system.mesh.size == 3
    slots, out = drive(system)
    assert system.mesh.size == 4 and system.env_slots == 12
    assert slots == ref_slots == [1, 5, 6]
    if system.fused_decide:
        # re-certified at the new mesh's width; the Predictor holds the
        # re-placed shard rings
        assert system.policy_certificate.shard_widths == (3,)
        assert all(r is d.replay for r, d in zip(system.predictor.replay,
                                                 system._dstate))
    _same_record(_record(system, out), want)
    system.stop()


@pytest.mark.parametrize("n", [3, 4])
def test_online_training_sharded_equals_unsharded(n, logical, tmp_path):
    """``train="online"`` in ``scan_fused_decide_sharded`` (mlp): the step
    runs on the first shard's device over the minibatch drawn across every
    shard's ring, and each applied policy is copied to every shard; two
    applied steps give the results, DB rows (with their versions), export,
    live policy and train stats of the unsharded system, bit for bit."""
    kw = dict(train="online", train_cfg={"batch_size": 16, "seed": 3})
    ref = _system("scan_fused_decide", tmp_path / "twin", "mlp", **kw)
    want = _record(ref, ref.run_windows(9))
    want_stats = ref.train_stats()
    ref.stop()
    logical(n)
    system = _system("scan_fused_decide_sharded", tmp_path / "sharded",
                     "mlp", **kw)
    got = _record(system, system.run_windows(9))
    assert system.policy_version() == 2
    assert system.train_stats() == want_stats
    for d in system._dstate:
        _equal_trees(d.policy, want["policy"], "every shard's policy")
        assert int(d.version) == 2
    _same_record(got, want)
    system.stop()


def test_closure_only_model_is_refused_across_cards(logical, tmp_path):
    """A closure-only model keeps its weights on one device: a mesh over
    two distinct devices refuses it, one device with logical shards runs
    it."""
    from repro_torch.runtime.predictor import ModelAdapter
    cfg = PipelineConfig(n_envs=4, use_kernel=True, **PCFG)
    pred = Predictor(ModelAdapter(lambda f: torch.tanh(f[:, :2]), "slice"),
                     energy_reward_spec(1, 0, 2), ActionSpace(*SPACE), 4,
                     cfg.n_features, device="cpu")
    decide = pred.make_decide_fn()
    two = sh.EnvMesh((CPU, torch.device("meta")))
    with pytest.raises(ValueError, match="closure-only"):
        pl.PerceptaPipeline(cfg, "scan_fused_decide_sharded", device=CPU,
                            decide=decide, mesh=two,
                            decide_state=pred.decide_state())
    pl.PerceptaPipeline(cfg, "scan_fused_decide_sharded", device=CPU,
                        decide=decide, mesh=sh.env_mesh(4, [CPU] * 2),
                        decide_state=pred.decide_state())


# ------------------------------------------------------ against the JAX one
def _jax_pair(mode, tmp_path, n_envs=3):
    envs = [f"bldg-{i}" for i in range(n_envs)]
    space = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
    jcfg = JaxConfig(use_pallas=True, n_envs=n_envs, **dict(
        PCFG, max_samples=32))
    model = jpol.rglru_builder(3, 2, n_envs=n_envs, hidden=16, seed=4)
    jpred = JaxPredictor(model, jax_energy(1, 0, 2), JaxSpace(*space),
                         n_envs, jcfg.n_features, replay_capacity=16)
    hub = lambda fwd, h: h([fwd("hvac", "mqtt", [0]),
                            fwd("ev-charger", "amqp", [1])])
    jsrc = _sources(JaxSource, JaxDevice)
    # the reference's scan_sharded gate reads a stateless view of the
    # model, which a recurrent policy has not; its gate is not compared
    jsys = JaxSystem(envs, jsrc, jcfg, jpred, forwarders=hub(JaxForwarder,
                                                             JaxHub),
                     db=JaxLogDB(str(tmp_path / "jax"), salt="s"),
                     mode=mode, t0=2.0 ** 24, manual_time=True, scan_k=3,
                     contract_check=mode != "scan_sharded")
    cfg = PipelineConfig(n_envs=n_envs, use_kernel=True,
                         **dict(PCFG, max_samples=32))
    params = convert.policy_params_from_numpy(
        "rglru", jax.tree.map(np.asarray, model.params), "cpu")
    pmodel = rglru_builder(3, 2, hidden=16, use_kernel=True, params=params,
                           device="cpu")
    pred = Predictor(pmodel, energy_reward_spec(1, 0, 2),
                     ActionSpace(*space), n_envs, cfg.n_features,
                     replay_capacity=16, device="cpu")
    psys = PerceptaSystem(envs, _sources(), cfg, pred,
                          forwarders=hub(Forwarder, ForwarderHub),
                          db=LogDB(str(tmp_path / "port"), salt="s"),
                          mode=mode, t0=2.0 ** 24, manual_time=True,
                          scan_k=3, device="cpu")
    return jsys, psys


@pytest.mark.parametrize("mode", ["scan_sharded",
                                  "scan_fused_decide_sharded"])
def test_sharded_system_matches_jax(mode, logical, tmp_path):
    """The port's sharded mode on 3 logical shards against the JAX
    system's same mode (one device) over 6 windows at t0 = 2^24."""
    logical(3)
    jsys, psys = _jax_pair(mode, tmp_path)
    assert psys.mesh.size == 3
    want, got = jsys.run_windows(6), psys.run_windows(6)
    for w, g in zip(want, got):
        for key in w:
            if key == "mean_reward":
                assert_allclose(g[key], w[key], **TOL)
            elif key != "latency_s":
                assert g[key] == w[key], key
    jrows = [r for _, r in jsys.db.read_from()]
    prows = [r for _, r in psys.db.read_from()]
    assert len(prows) == len(jrows) == 18
    for pr, jr in zip(prows, jrows):
        assert (pr["env"], pr["t"]) == (jr["env"], jr["t"])
        for key in ("obs", "action", "reward"):
            assert_allclose(pr[key], jr[key], **TOL)
    assert psys.replay_size() == jsys.replay_size() == 5
    wexp, gexp = jsys.export_replay("salt"), psys.export_replay("salt")
    assert gexp["env_ids"] == wexp["env_ids"]
    for key in ("tick_idx", "version", "valid", "times"):
        assert np.array_equal(gexp[key], wexp[key]), key
    for key in ("obs", "actions", "rewards", "next_obs"):
        assert_allclose(gexp[key], wexp[key], **TOL)
    jsys.stop()
    psys.stop()
