"""Online retraining in the port (``train="online"``): the optimizer, the
replay draw, the loss, the train step, the checkpointer and the whole
fused-decide system against the JAX package, and the port's own
bit-for-bit rules (``tests/test_trainer.py``'s, held within the port).

The port cannot reproduce ``jax.random``'s threefry stream, so the draw is
split from the gather: each parity test feeds the port's gather the
``(es, ss)`` that the JAX key chain draws, exactly as
``repro.core.replay.sample_device`` draws them.

Tolerances:
  * ``STEP_REL`` = 1e-5, norm-wise per leaf: max |port - jax| <= 1e-5 *
    max |jax| over each leaf of the params, ``m``, ``v`` and the critic,
    and for the loss, the grad norm and the schedule. XLA and torch sum
    the loss, the global norm and the row dots in other orders; AdamW
    then divides ``m`` by ``sqrt(v)``, which keeps each leaf's relative
    error where it was. A leaf that is all zeros (the policy's moments
    before the critic moves) must be exactly zero.
  * indices, gathers, counters, ``policy_version``, the step count, masks
    and checkpoints exactly;
  * the system's results against the JAX system at rtol = atol = 1e-4
    (``tests/test_torch_system.py``'s ``TOL``).
Within the port everything is bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import PipelineConfig as JaxConfig
from repro.core import replay as jrp
from repro.core.reward import energy_reward_spec as jax_energy
from repro.runtime import policies as jpol
from repro.runtime import predictor as jpred
from repro.runtime import trainer as jtr
from repro.runtime.db import LogDB as JaxLogDB
from repro.runtime.receivers import SimulatedDevice as JaxDevice
from repro.runtime.system import PerceptaSystem as JaxSystem
from repro.runtime.system import SourceSpec as JaxSource
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.core import PipelineConfig
from repro_torch.core import replay as rp
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime import policies as pol
from repro_torch.runtime import trainer as tr
from repro_torch.runtime.db import LogDB
from repro_torch.runtime.predictor import (ActionSpace, ModelAdapter,
                                            Predictor, policy_call)
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.train import tree

STEP_REL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
E, F, A, C, B = 6, 5, 2, 64, 16
SPACE = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
T_ = lambda x: torch.from_numpy(np.array(x))   # a writable private copy


def _np(t):
    return jax.tree.map(np.asarray, t)


def _close(got, want, what=""):
    """``STEP_REL``, norm-wise per leaf (module docstring)."""
    g, w = tree.leaves(got), jax.tree.leaves(_np(want))
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        scale = np.abs(b).max() if b.size else 0.0
        if scale == 0:
            assert np.array_equal(a, b), (what, i)
        else:
            err = np.abs(a.astype(np.float64) - b).max()
            assert err <= STEP_REL * scale, (what, i, err, scale)


def _equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _jax_indices(key, buf_size, batch, n_envs):
    """The ``(es, ss)`` ``repro.core.replay.sample_device`` draws from
    ``key`` (the trainer's per-step subkey), as int64 tensors."""
    ke, ks = jax.random.split(key)
    es = jax.random.randint(ke, (batch,), 0, n_envs)
    ss = jax.random.randint(ks, (batch,), 0,
                            jnp.maximum(jnp.int32(buf_size), 1))
    return (torch.from_numpy(np.asarray(es).astype(np.int64)),
            torch.from_numpy(np.asarray(ss).astype(np.int64)))


def _jax_draw(batch, n_envs, seed=0):
    """A port ``OnlineTrainer.draw`` that follows the JAX trainer's key
    chain (split per dispatch, then ``sample_device``'s split)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(replay):
        key[0], sub = jax.random.split(key[0])
        n = min(int(replay.cursor), replay.capacity)
        return _jax_indices(sub, n, batch, n_envs)

    return draw


def _rings(n, rng, cap=C):
    """A JAX ring after ``n`` adds of random rows and the same ring in the
    port; ``obs[:, 0]`` holds the tick so a gathered row names its slot."""
    jbuf = jrp.init(E, cap, F, A)
    for j in range(n):
        obs = rng.normal(0, 1, (E, F)).astype(np.float32)
        obs[:, 0] = j
        jbuf = jrp.add(jbuf, jnp.asarray(obs),
                       jnp.asarray(rng.uniform(-1, 1, (E, A)), jnp.float32),
                       jnp.asarray(rng.normal(0, 3, (E,)), jnp.float32),
                       jnp.asarray(rng.normal(0, 1, (E, F)), jnp.float32),
                       jnp.int32(j), version=jnp.int32(j % 3))
    return jbuf, convert.replay_from_numpy(_np(jbuf))


def _cfgs(**kw):
    return JaxTrainConfig(**kw), TrainConfig(**kw)


# --------------------------------------------------------------- optimizer
def test_optimizer_update_schedule_and_clip_match_jax(rng):
    """Six AdamW steps from the same params and gradients, with warmup,
    the cosine tail, weight decay and a clip that binds on odd steps."""
    jcfg, pcfg = _cfgs(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                       weight_decay=0.1, grad_clip=1.0)
    params = {"b": rng.normal(0, 1, (3,)).astype(np.float32),
              "a": {"w": rng.normal(0, 1, (4, 2)).astype(np.float32),
                    "s": np.float32(0.5)}}
    jp, pp = jax.tree.map(jnp.asarray, params), jax.tree.map(T_, params)
    js, ps = jopt.init(jp), opt.init(pp)
    for step in range(6):
        scale = 3.0 if step % 2 else 0.05
        g = jax.tree.map(lambda x: (rng.normal(0, scale, np.shape(x))
                                    .astype(np.float32)), params)
        jg, pg = jax.tree.map(jnp.asarray, g), jax.tree.map(T_, g)
        _close(opt.clip_by_global_norm(pg, 1.0),
               jopt.clip_by_global_norm(jg, 1.0), "clip")
        jp, js, jn = jopt.update(jg, js, jp, jcfg)
        pp, ps, pn = opt.update(pg, ps, pp, pcfg)
        _close(pp, jp, f"params {step}")
        _close((ps["m"], ps["v"], pn), (js["m"], js["v"], jn),
               f"moments {step}")
        assert int(ps["step"]) == int(js["step"]) == step + 1
        assert ps["step"].dtype == torch.int32
        _close(opt.schedule(pcfg, ps["step"]),
               jopt.schedule(jcfg, js["step"]), "schedule")
    # tree order is jax.tree.flatten's: dict keys sorted, recursively
    assert [tuple(x.shape) for x in tree.leaves(pp)] == \
        [x.shape for x in jax.tree.leaves(jp)]


def test_optimizer_is_pure(rng):
    """``update`` returns new tensors and writes none of its inputs."""
    p = {"w": T_(rng.normal(0, 1, (3, 2)).astype(np.float32))}
    g = {"w": T_(rng.normal(0, 1, (3, 2)).astype(np.float32))}
    s = opt.init(p)
    before = [x.clone() for x in tree.leaves((p, g, s))]
    opt.update(g, s, p, TrainConfig(weight_decay=0.1))
    assert all(torch.equal(x, y)
               for x, y in zip(before, tree.leaves((p, g, s))))


# ----------------------------------------------------------------- replay
@pytest.mark.parametrize("n", [0, 3, 40, 150], ids=["empty", "partial",
                                                   "partial-many",
                                                   "wrapped"])
def test_sample_device_gather_matches_jax(n, rng):
    """Fed the JAX draw's own indices, the port's gather returns the JAX
    ``sample_device`` minibatch bit for bit, ``valid`` included."""
    jbuf, pbuf = _rings(n, rng)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = _np(jrp.sample_device(jbuf, key, 64))
        es, ss = _jax_indices(key, min(n, C), 64, E)
        got = rp.gather(pbuf, es, ss)
        assert set(got) == set(want)
        for k in want:
            assert got[k].numpy().dtype == want[k].dtype, k
            assert np.array_equal(got[k].numpy(), want[k]), k
        assert bool(got["valid"].any()) == (n > 0)


@pytest.mark.parametrize("n,live", [(0, {0}), (3, {0, 1, 2}),
                                    (150, set(range(150 - C, 150)))],
                         ids=["empty", "partial", "wrapped"])
def test_draw_device_reaches_live_slots_only(n, live, rng):
    _, pbuf = _rings(n, rng)
    gen = torch.Generator().manual_seed(0)
    batch = rp.sample_device(pbuf, gen, 4096)
    ticks = set(batch["tick_idx"].tolist())
    assert (ticks == live) if n else (ticks == {0})
    assert bool(batch["valid"].all()) == (n > 0)
    assert not bool(batch["valid"].any()) or n > 0
    # row coherence: every column comes from the same (env, slot)
    assert torch.equal(batch["obs"][:, 0], batch["tick_idx"].float())
    assert torch.equal(batch["version"], batch["tick_idx"] % 3)
    assert all(not x.requires_grad for x in batch.values())
    # the same generator state and ring size give the same indices
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert all(torch.equal(x, y) for x, y in zip(
        rp.draw_device(pbuf, g1, 33), rp.draw_device(pbuf, g2, 33)))
    if n == 0:
        with pytest.raises(ValueError, match="empty"):
            rp.sample(pbuf, gen, 8)
    else:
        assert rp.sample(pbuf, gen, 8)["valid"].all()


# ------------------------------------------------------------- loss, step
def _pair(name, seed=3, capacity=C, lr=1e-2):
    """A JAX Predictor + trainer and the port's on the same weights."""
    kw = {"hidden": 8} if name == "mlp" else {}
    jm = jpol.POLICIES[name](F, A, n_envs=E, seed=seed, **kw)
    jp = jpred.Predictor(jm, jax_energy(1, 0, 2), jpred.ActionSpace(*SPACE),
                         E, F, replay_capacity=capacity)
    jt = jtr.OnlineTrainer(jp, batch_size=B, contract_check=False,
                           train_cfg=jtr.default_train_cfg(learning_rate=lr))
    pm = pol.POLICIES[name](F, A, params=convert.policy_params_from_numpy(
        name, _np(jm.params)), device="cpu", **kw)
    pp = Predictor(pm, energy_reward_spec(1, 0, 2), ActionSpace(*SPACE), E,
                   F, replay_capacity=capacity, device="cpu")
    pt = tr.OnlineTrainer(pp, batch_size=B,
                          train_cfg=tr.default_train_cfg(learning_rate=lr))
    return jt, pt


@pytest.mark.parametrize("name", ["linear", "mlp"])
def test_td_loss_and_gradients_match_jax(name, rng):
    jt, pt = _pair(name)
    jbuf, pbuf = _rings(20, rng)
    key = jax.random.PRNGKey(1)
    jbatch = jrp.sample_device(jbuf, key, B)
    pbatch = rp.gather(pbuf, *_jax_indices(key, 20, B, E))
    critic = {"qw": rng.normal(0, 0.5, (F + A,)).astype(np.float32),
              "qb": np.float32(0.3)}
    japply, jparams = jpred.policy_call(jt.predictor.model)
    papply, pparams = policy_call(pt.predictor.model)
    jjoint = {"policy": jparams, "critic": jax.tree.map(jnp.asarray,
                                                         critic)}
    jl, jg = jax.value_and_grad(lambda j: jtr.td_loss(
        japply, j["policy"], j["critic"], jbatch))(jjoint)
    flat, td = tree.flatten({"policy": pparams,
                             "critic": jax.tree.map(T_, critic)})
    live = [x.detach().requires_grad_() for x in flat]
    j = tree.unflatten(td, live)
    pl_ = tr.td_loss(papply, j["policy"], j["critic"], pbatch)
    pg = torch.autograd.grad(pl_, live)
    _close(pl_, jl, "loss")
    _close(tree.unflatten(td, list(pg)), jg, "grads")
    # an all-invalid batch: loss 0, zero gradients
    empty = dict(pbatch, valid=torch.zeros_like(pbatch["valid"]))
    z = tr.td_loss(papply, j["policy"], j["critic"], empty)
    assert float(z.detach()) == 0.0
    assert all(float(g.abs().max()) == 0.0
               for g in torch.autograd.grad(z, live))


@pytest.mark.parametrize("name", ["linear", "mlp"])
def test_step_fn_matches_jax(name, rng):
    """Five steps of ``step_fn`` from the same params, state and indices:
    loss, grad norm, new params, the critic, ``m``, ``v`` and the step."""
    jt, pt = _pair(name)
    jbuf, pbuf = _rings(40, rng)
    jparams, pparams = jt.predictor.policy_params, pt.predictor.policy_params
    jts, pts = jt.train_state, pt.train_state
    key = jax.random.PRNGKey(0)
    for step in range(5):
        key, sub = jax.random.split(key)
        es, ss = _jax_indices(sub, 40, B, E)
        jout = jt.step_fn(jparams, jts, jbuf, sub)
        pout = pt.step_fn(pparams, pts, pbuf, es, ss)
        _close(pout[0], jout[0], f"params {step}")
        _close(pout[1]["critic"], jout[1]["critic"], f"critic {step}")
        _close((pout[1]["opt"]["m"], pout[1]["opt"]["v"]),
               (jout[1]["opt"]["m"], jout[1]["opt"]["v"]), f"m, v {step}")
        _close(pout[2:4], jout[2:4], f"loss, gnorm {step}")
        assert int(pout[1]["opt"]["step"]) == int(jout[1]["opt"]["step"]) \
            == step + 1
        assert bool(pout[4]) and bool(jout[4])
        jparams, jts, pparams, pts = jout[0], jout[1], pout[0], pout[1]


def test_empty_ring_step_is_an_exact_noop():
    """A step on a fresh ring returns its inputs' bits: no decay drift, no
    step advance (weight decay on, so a missed gate would show), and the
    version stays 0."""
    pred = Predictor("linear", energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, F, replay_capacity=8,
                     device="cpu")
    t = tr.OnlineTrainer(pred, batch_size=8,
                         train_cfg=tr.default_train_cfg(weight_decay=0.5))
    ds = pred.decide_state()
    policy0, tstate0 = tree.map_(torch.clone, ds.policy), \
        tree.map_(torch.clone, t.train_state)
    t.dispatch(ds)
    ds2 = t.apply_pending(ds)
    assert t.stats["skipped_empty"] == 1 and t.stats["applied"] == 0
    assert t.version == 0 and pred.policy_version == 0
    assert int(ds2.version) == 0 and ds2 is ds
    assert _equal(ds2.policy, policy0)
    assert _equal(t.train_state, tstate0)


def test_trainer_refusals():
    """A model without params and a stateful model (through
    ``policy_call``) are refused at construction."""
    opaque = Predictor(ModelAdapter(lambda f: torch.zeros(f.shape[:-1]
                                                          + (A,)), "opaque"),
                       energy_reward_spec(1, 0, 2), ActionSpace(*SPACE), E,
                       F, device="cpu")
    with pytest.raises(ValueError, match="parameterized"):
        tr.OnlineTrainer(opaque)
    for name in ("rglru", "rwkv6"):
        pred = Predictor(name, energy_reward_spec(1, 0, 2),
                         ActionSpace(*SPACE), E, F, device="cpu")
        with pytest.raises(ValueError, match="stateful"):
            tr.OnlineTrainer(pred)


def test_applied_step_moves_weights_and_syncs_the_mirror(rng):
    _, pt = _pair("linear")
    pred = pt.predictor
    _, pbuf = _rings(6, rng, cap=C)
    ds = pred.decide_state()._replace(replay=pbuf)
    w0 = ds.policy["w"].clone()
    pt.dispatch(ds)
    ds = pt.apply_pending(ds)
    assert pt.stats["applied"] == 1 and pt.version == 1
    assert int(ds.version) == 1
    st = pt.train_stats()
    assert np.isfinite(st["last_loss"]) and st["last_loss"] > 0
    assert st["version"] == 1
    # step 1 fits the critic (the policy term's gradient is zero while the
    # critic is zero), so the policy moves from step 2 on
    assert float(pt.train_state["critic"]["qw"].abs().max()) > 0
    assert torch.equal(ds.policy["w"], w0)
    pt.dispatch(ds)
    ds = pt.apply_pending(ds)
    assert pt.version == 2 and pred.policy_version == 2
    assert float((ds.policy["w"] - w0).abs().max()) > 0
    assert pred.policy_params["w"] is ds.policy["w"]


# -------------------------------------------------------------- checkpoint
def test_checkpoints_cross_restore_bit_for_bit(tmp_path, rng):
    """A JAX trainer's checkpoint restores into the port's trainer bit for
    bit, and a port trainer's into the JAX one's."""
    jt, pt = _pair("mlp")
    jbuf, pbuf = _rings(30, rng)
    key = jax.random.PRNGKey(0)
    for _ in range(2):            # move params and moments off their init
        key, sub = jax.random.split(key)
        jout = jt.step_fn(jt.predictor.policy_params, jt.train_state, jbuf,
                          sub)
        jt.train_state = jout[1]
        jt.predictor.adopt_policy(jout[0], 2)
        pout = pt.step_fn(pt.predictor.policy_params, pt.train_state, pbuf,
                          *_jax_indices(key, 30, B, E))
        pt.train_state = pout[1]
        pt.predictor.adopt_policy(pout[0], 2)
    jtree = _np({"params": jt.predictor.policy_params,
                 "train": jt.train_state})
    ptree = {"params": pt.predictor.policy_params, "train": pt.train_state}

    # convert carries a JAX trainer state across in the port's layout
    conv = convert.train_state_from_numpy(jtree["train"])
    assert tree.flatten(conv)[1] == tree.flatten(pt.train_state)[1]
    assert [x.numpy().tobytes() for x in tree.leaves(conv)] == \
        [x.tobytes() for x in jax.tree.leaves(jtree["train"])]

    jck.Checkpointer(str(tmp_path / "j"), async_mode=False).save(
        7, jtree, extra={"policy_version": 2})
    got, extra = ck.Checkpointer(str(tmp_path / "j")).restore(7, ptree)
    assert extra == {"policy_version": 2}
    assert [x.numpy().tobytes() for x in tree.leaves(got)] == \
        [x.tobytes() for x in jax.tree.leaves(jtree)]
    assert [x.dtype for x in tree.leaves(got)] == \
        [x.dtype for x in tree.leaves(ptree)]

    pck = ck.Checkpointer(str(tmp_path / "p"))     # async writer
    pck.save(9, ptree, extra={"policy_version": 2})
    pck.close()
    jgot, _ = jck.Checkpointer(str(tmp_path / "p"), async_mode=False) \
        .restore(9, jtree)
    assert [np.asarray(x).tobytes() for x in jax.tree.leaves(jgot)] == \
        [x.numpy().tobytes() for x in tree.leaves(ptree)]


def test_checkpointer_flush_waits_and_keeps_n(tmp_path):
    """``flush`` returns once every queued write is on disk (no polling
    window); keep-N drops the oldest; the saved copy is taken before
    ``save`` returns, so a later in-place write does not reach it."""
    c = ck.Checkpointer(str(tmp_path), keep=2)
    x = torch.zeros(1000)
    for step in range(5):
        x.fill_(step)
        c.save(step, {"x": x})
    x.fill_(-1)
    c.flush()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004"]
    assert c.latest_step() == 4
    got, _ = c.restore(4, {"x": x})
    assert torch.equal(got["x"], torch.full((1000,), 4.0))
    with pytest.raises(ValueError, match="leaves"):
        c.restore(4, {"x": x, "y": x})
    c.close()


# ------------------------------------------------------------------ system
ENVS = 4
K = 4


def _sources(spec, device):
    return [spec("meter", "mqtt", device("grid_kw", 60.0, base=3.0, seed=1)),
            spec("price", "http", device("price_eur", 300.0, base=0.2,
                                         amplitude=0.05, seed=2))]


def _pcfg(cls, **kw):
    return cls(n_envs=ENVS, n_streams=2, n_ticks=8, tick_s=60.0,
               max_samples=32, gap_strategy="locf", feature_agg="mean", **kw)


def _port_system(mode, name="linear", params=None, db=None, cap=C,
                 **kw):
    cfg = _pcfg(PipelineConfig, use_kernel=True)
    pkw = {"hidden": 8} if name == "mlp" else {}
    model = pol.POLICIES[name](cfg.n_features, 2, seed=3, params=params,
                               device="cpu", **pkw)
    pred = Predictor(model, energy_reward_spec(1, 0, 0), ActionSpace(*SPACE),
                     ENVS, cfg.n_features, replay_capacity=cap,
                     device="cpu")
    return PerceptaSystem([f"bldg-{i}" for i in range(ENVS)],
                          _sources(SourceSpec, SimulatedDevice), cfg, pred,
                          db=None if db is None else LogDB(db, salt="x"),
                          manual_time=True, mode=mode, scan_k=K,
                          device="cpu", **kw)


def _jax_system(name, db):
    cfg = _pcfg(JaxConfig)
    pkw = {"hidden": 8} if name == "mlp" else {}
    model = jpol.POLICIES[name](cfg.n_features, 2, seed=3, **pkw)
    pred = jpred.Predictor(model, jax_energy(1, 0, 0),
                           jpred.ActionSpace(*SPACE), ENVS, cfg.n_features,
                           replay_capacity=C)
    return JaxSystem([f"bldg-{i}" for i in range(ENVS)],
                     _sources(JaxSource, JaxDevice), cfg, pred,
                     db=JaxLogDB(db, salt="x"), manual_time=True,
                     mode="scan_fused_decide", scan_k=K, train="online",
                     train_cfg={"batch_size": B, "contract_check": False,
                                "train_cfg": jtr.default_train_cfg(
                                    learning_rate=1e-2)})


def _rows(db, key="logged_at"):
    return [{k: v for k, v in row.items() if k != key}
            for _, row in db.read_from()]


@pytest.mark.parametrize("mode", ["scan_fused_decide",
                                  "scan_fused_decide_async"])
@pytest.mark.parametrize("name", ["linear", "mlp"])
def test_online_system_matches_jax(mode, name, tmp_path):
    """The port system with ``train="online"`` beside the JAX one over 4
    batches (a first batch of one window, whose step finds an empty ring,
    then three of K), the port's draw fed the JAX key chain's indices:
    versions and counters exactly, the live params
    and the result of the step launched after every batch within
    ``STEP_REL``, results and rows within ``TOL``."""
    jsys = _jax_system(name, str(tmp_path / "jax"))
    psys = _port_system(mode, name, params=convert.policy_params_from_numpy(
        name, _np(jsys.predictor.policy_params)), db=str(tmp_path / "port"),
        train="online", train_cfg={"batch_size": B, "train_cfg":
                                   tr.default_train_cfg(learning_rate=1e-2)})
    psys.trainer.draw = _jax_draw(B, ENVS)
    p0 = psys.snapshot_policy()
    for n in (1, K, K, K):
        want, got = jsys.run_windows(n), psys.run_windows(n)
        for w, g in zip(want, got):
            assert_allclose(g["mean_reward"], w["mean_reward"], **TOL)
            assert g["window"] == w["window"]
        assert psys.policy_version() == jsys.policy_version()
        js, ps = jsys.train_stats(), psys.train_stats()
        for k in ("dispatched", "applied", "skipped_empty", "version"):
            assert ps[k] == js[k], k
        _close(psys.snapshot_policy(), jsys.snapshot_policy(), "policy")
        # the step just launched (the JAX trainer donated its old state)
        _close(psys.trainer._pending[:2], jsys.trainer._pending[:2],
               "launched step")
    assert not _equal(psys.snapshot_policy(), p0)
    assert (ps["dispatched"], ps["applied"], ps["skipped_empty"]) == (4, 2, 1)
    assert psys.policy_version() == 2
    jrows, prows = _rows(jsys.db), _rows(psys.db)
    assert [r["policy_version"] for r in prows] == \
        [r["policy_version"] for r in jrows]
    for pr, jr in zip(prows, jrows):
        assert_allclose(pr["action"], jr["action"], **TOL)
    wexp, gexp = jsys.export_replay("s"), psys.export_replay("s")
    for key in ("tick_idx", "version", "valid", "times"):
        assert np.array_equal(gexp[key], wexp[key]), key
    jsys.stop(), psys.stop()
    jsys.db.close(), psys.db.close()


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


def _export_equal(a, b):
    assert a["env_ids"] == b["env_ids"]
    for key in a:
        if key != "env_ids":
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), key


def test_training_off_is_the_untrained_path_at_version_zero(tmp_path):
    """With no trainer the fused path equals ``scan`` bit for bit, and
    every row and replay cell carries version 0."""
    ref = _port_system("scan", db=str(tmp_path / "ref"))
    off = _port_system("scan_fused_decide", db=str(tmp_path / "off"))
    assert off.train_stats() is None
    assert _strip(ref.run_windows(9)) == _strip(off.run_windows(9))
    assert _rows(ref.db) == _rows(off.db)
    assert all(r["policy_version"] == 0 for r in _rows(off.db))
    exp = off.export_replay("s")
    _export_equal(exp, ref.export_replay("s"))
    assert (exp["version"] == 0).all()
    for s in (ref, off):
        s.stop()
        s.db.close()


@pytest.mark.parametrize("name", ["linear", "mlp"])
def test_training_on_equals_off_until_the_first_swap(name, tmp_path):
    on = _port_system("scan_fused_decide", name, db=str(tmp_path / "on"),
                      train="online", train_cfg={"batch_size": B})
    off = _port_system("scan_fused_decide", name, db=str(tmp_path / "off"))
    assert _strip(on.run_windows(K)) == _strip(off.run_windows(K))
    assert _rows(on.db) == _rows(off.db)
    _export_equal(on.export_replay("s"), off.export_replay("s"))
    # the first step applies at the next boundary; it fits the critic
    # alone (the policy's gradient is zero while the critic is zero), so
    # the policy itself moves from the second applied step on
    assert on.train_stats()["dispatched"] == 1
    on.run_windows(K), off.run_windows(K)
    assert on.policy_version() == 1 and off.policy_version() == 0
    assert _equal(on.snapshot_policy(), off.snapshot_policy())
    on.run_windows(K), off.run_windows(K)
    assert on.policy_version() == 2
    assert not _equal(on.snapshot_policy(), off.snapshot_policy())
    for s in (on, off):
        s.stop()
        s.db.close()


def test_async_twin_equals_sync_with_training(tmp_path):
    systems = {m: _port_system(m, "mlp", db=str(tmp_path / m),
                               train="online", train_cfg={"batch_size": B})
               for m in ("scan_fused_decide", "scan_fused_decide_async")}
    out = {m: _strip(s.run_windows(3 * K) + s.run_windows(K + 1))
           for m, s in systems.items()}
    sync, asyn = systems.values()
    assert out["scan_fused_decide"] == out["scan_fused_decide_async"]
    assert _rows(sync.db) == _rows(asyn.db)
    _export_equal(sync.export_replay("s"), asyn.export_replay("s"))
    assert sync.train_stats() == asyn.train_stats()
    assert sync.policy_version() == asyn.policy_version() == 4
    assert _equal(sync.snapshot_policy(), asyn.snapshot_policy())
    assert _equal(sync.trainer.train_state, asyn.trainer.train_state)
    for s in systems.values():
        s.stop()
        s.db.close()


def test_policy_version_rides_rows_and_replay(tmp_path):
    """12 windows in batches of K = 4: versions 0, 1, 2 served. Every DB
    row carries its batch's version; a replay row carries the version that
    produced its ACTION (the previous window's), so in each batch only the
    row banked first carries the previous batch's version."""
    s = _port_system("scan_fused_decide", db=str(tmp_path / "db"),
                     train="online", train_cfg={"batch_size": B})
    s.run_windows(3 * K)
    s.stop()
    assert s.policy_version() == 2
    st = s.train_stats()
    assert (st["dispatched"], st["applied"], st["skipped_empty"]) == (3, 2, 0)
    served = [r["policy_version"] for r in _rows(s.db)]
    assert served == [v for v in (0, 1, 2) for _ in range(K * ENVS)]
    ver = s.export_replay("s")["version"]
    want = np.array([0] * (K - 1) + [0] + [1] * (K - 1) + [1] + [2] * (K - 1),
                    np.int32)
    assert (ver == want[None, :]).all()
    assert (np.diff(ver, axis=1) >= 0).all()
    s.db.close()


def test_restore_training_round_trips_into_the_live_carry(tmp_path):
    ckdir = str(tmp_path / "ck")
    cfg = {"batch_size": B, "checkpoint_dir": ckdir, "checkpoint_every": 1}
    s1 = _port_system("scan_fused_decide", "mlp", train="online",
                      train_cfg=cfg)
    s1.run_windows(3 * K)
    s1.stop()
    v1, p1 = s1.policy_version(), s1.snapshot_policy()
    state1 = tree.map_(torch.clone, s1.trainer.train_state)
    assert v1 == 2

    s2 = _port_system("scan_fused_decide", "mlp", train="online",
                      train_cfg=dict(cfg, checkpoint_every=0))
    assert s2.policy_version() == 0
    step, params, extra = s2.restore_training()
    assert step == 2 and extra == {"policy_version": 2, "applied": 2}
    assert s2.policy_version() == v1 and int(s2._dstate.version) == v1
    # the LIVE carry serves the saved bits, and so does the mirror
    assert _equal(s2.snapshot_policy(), p1)
    assert _equal(s2.predictor.policy_params, p1)
    assert _equal(s2.trainer.train_state, state1)
    assert s2.trainer.stats["applied"] == 2
    # the first batch after the restore is stamped with the restored version
    s2.run_windows(K)
    assert (s2.export_replay("s")["version"] == v1).all()
    s2.stop()
    with pytest.raises(ValueError, match="train='online'"):
        _port_system("scan_fused_decide").restore_training()


def test_save_checkpoint_explicit_and_restore_without_one(tmp_path):
    pred = Predictor("mlp", energy_reward_spec(1, 0, 2), ActionSpace(*SPACE),
                     E, F, device="cpu")
    t = tr.OnlineTrainer(pred, batch_size=8,
                         checkpoint_dir=str(tmp_path / "a"))
    assert t.restore_latest() is None
    assert t.save_checkpoint(block=True) == 0
    step, params, extra = t.restore_latest()
    assert step == 0 and extra == {"policy_version": 0, "applied": 0}
    assert _equal(params, pred.policy_params)
    t.close()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.OnlineTrainer(pred).save_checkpoint()


# ------------------------------------------------------- registry policies
@pytest.mark.parametrize("name", ["mlp", "rwkv6"])
def test_predictor_with_jax_policy_matches_jax(name, rng):
    """The Predictor's K-window consume with ``mlp`` / ``rwkv6`` on JAX
    weights (``convert``) against the JAX Predictor, two batches (the
    rwkv6 carry crosses them)."""
    jm = jpol.POLICIES[name](F, A, n_envs=E, seed=4)
    jp = jpred.Predictor(jm, jax_energy(1, 0, 2), jpred.ActionSpace(*SPACE),
                         E, F, replay_capacity=8)
    pm = pol.build_policy(pol.PolicyConfig(name), F, A, E,
                          params=convert.policy_params_from_numpy(
                              name, _np(jm.params)), device="cpu")
    pp = Predictor(pm, energy_reward_spec(1, 0, 2), ActionSpace(*SPACE), E,
                   F, replay_capacity=8, device="cpu")
    for b in range(2):
        f = rng.normal(0, 1, (3, E, F)).astype(np.float32)
        times = [480.0 * (3 * b + j + 1) for j in range(3)]
        want = jp.on_windows(jnp.asarray(f), times)
        got = pp.on_windows(T_(f), times)
        for g, w in zip(got, want):
            assert_allclose(g, w, **TOL)
    if name == "rwkv6":
        for k in ("shift", "wkv"):
            assert_allclose(pp._model_carry[k].numpy(),
                            np.asarray(jp._model_carry[k]), **TOL)
