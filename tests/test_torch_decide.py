"""The port's decide path (reward, replay ring, policies, Predictor) against
the JAX package, plus the port's own "K windows == K single ticks" rule.

Tolerances: actions and rewards of one module rtol = atol = 1e-5 (the
repo's single-module bound; XLA and torch round transcendental functions
and sums differently); the replay cursor, tick_idx, version, valid and
anonymized ids exactly; times exactly (host float64 on both sides). Inside
the port ``on_windows`` must equal K ``on_tick`` calls bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import replay as jrp
from repro.core import reward as jrw
from repro.runtime import policies as jpol
from repro.runtime import predictor as jpred
from repro_torch import convert
from repro_torch.core import replay as rp
from repro_torch.core import reward as rw
from repro_torch.runtime import policies as pol
from repro_torch.runtime.predictor import (ActionSpace, Predictor,
                                            linear_policy, policy_call)

TOL = dict(rtol=1e-5, atol=1e-5)
T_ = lambda x: torch.from_numpy(np.array(x))  # a writable private copy
E, F, A = 3, 3, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _terms(mod):
    return (mod.RewardTerm("linear", weight=0.5, feature=1),
            mod.RewardTerm("abs_error", weight=1.5, feature=0, target=2.0),
            mod.RewardTerm("quadratic_error", feature=2, target=-1.0),
            mod.RewardTerm("band_penalty", weight=2.0, feature=2,
                           target=0.5, band=0.3),
            mod.RewardTerm("threshold_bonus", weight=3.0, feature=1,
                           target=0.1),
            mod.RewardTerm("action_smoothness", weight=0.1, action=1))


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("spec", ["builtin", "energy"])
def test_reward_and_validate(lead, spec, rng):
    f = rng.normal(0, 2, lead + (E, F)).astype(np.float32)
    a = rng.normal(0, 1.5, lead + (E, A)).astype(np.float32)
    p = rng.normal(0, 1, lead + (E, A)).astype(np.float32)
    if spec == "energy":
        js, ps = (jrw.energy_reward_spec(1, 0, 2),
                  rw.energy_reward_spec(1, 0, 2))
    else:
        js, ps = (jrw.RewardSpec(_terms(jrw)), rw.RewardSpec(_terms(rw)))
    wt, wp = js.compute(jnp.asarray(f), jnp.asarray(a), jnp.asarray(p))
    gt, gp = ps.compute(T_(f), T_(a), T_(p))
    assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    assert_allclose(gt.numpy(), np.asarray(wt), **TOL)
    if lead:   # K-leading == per-window, bit for bit
        for k in range(lead[0]):
            t1, p1 = ps.compute(T_(f[k]), T_(a[k]), T_(p[k]))
            assert torch.equal(t1, gt[k]) and torch.equal(p1, gp[k])
    low, high = np.array([-1.0, -0.5], np.float32), np.ones(A, np.float32)
    wc, wv = jrw.validate_actions(jnp.asarray(a), low, high)
    gc, gv = rw.validate_actions(T_(a), T_(low), T_(high))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gv.numpy(), np.asarray(wv)) and gv.any()


def _transitions(rng, K):
    return (rng.normal(0, 1, (K, E, F)).astype(np.float32),
            rng.normal(0, 1, (K, E, A)).astype(np.float32),
            rng.normal(0, 1, (K, E)).astype(np.float32),
            rng.normal(0, 1, (K, E, F)).astype(np.float32),
            np.arange(10, 10 + K, dtype=np.int32))


@pytest.mark.parametrize("C,K", [(8, 5), (4, 6), (3, 11)])  # K > C wraps
def test_replay_add_many_matches_jax_and_sequential_adds(C, K, rng):
    obs, act, rew, nxt, tick = _transitions(rng, K)
    mask = np.ones(K, bool)
    mask[1] = False
    ver = np.arange(K, dtype=np.int32) % 3
    want = jrp.add_many(jrp.init(E, C, F, A), *map(jnp.asarray, (
        obs, act, rew, nxt, tick)), jnp.asarray(mask), jnp.asarray(ver))
    got = rp.add_many(rp.init(E, C, F, A), *map(T_, (obs, act, rew, nxt,
                                                     tick)), mask, ver)
    seq = rp.init(E, C, F, A)
    for k in range(K):
        if mask[k]:
            rp.add(seq, T_(obs[k]), T_(act[k]), T_(rew[k]), T_(nxt[k]),
                   T_(tick[k]), int(ver[k]))
    for g, s, w in zip(got, seq, want):
        assert torch.equal(g, s)
        assert g.dtype == s.dtype
        # pure copies of the same inputs: exact against the reference
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got.tick_idx.dtype == torch.int32 and got.cursor.dtype == \
        torch.int32
    times = np.arange(C, dtype=np.float64) * 480.0 + 2.0 ** 24
    wexp = jrp.export_for_training(want, ["a", "b", "c"], "salt", times)
    gexp = rp.export_for_training(got, ["a", "b", "c"], "salt", times)
    assert gexp["env_ids"] == wexp["env_ids"]
    for key in wexp:
        if key != "env_ids":
            assert np.array_equal(gexp[key], wexp[key]), key


def _feats(rng, K):
    return rng.normal(0, 1, (K, E, F)).astype(np.float32)


@pytest.mark.parametrize("name", ["linear", "rglru", "mlp", "rwkv6"])
def test_policy_with_jax_weights(name, rng):
    kw = {"rglru": {"hidden": 16}, "mlp": {"hidden": 8},
          "rwkv6": {"hidden": 4}}.get(name, {})
    jad = jpol.POLICIES[name](F, A, n_envs=E, seed=3, **kw)
    params = convert.policy_params_from_numpy(
        name, _np(jad.params), "cpu")
    if name == "rglru":
        kw["use_kernel"] = True
    pad = pol.build_policy(pol.PolicyConfig(name, kw), F, A, E,
                           params=params, device="cpu")
    if name == "rglru":
        assert sorted(dict(pad.module.named_parameters())) == \
            sorted(jad.params)
    assert sorted(pad.params) == sorted(jad.params)
    jcarry = jad.init_carry(E) if jad.init_carry else None
    pcarry = pad.init_carry(E) if pad.init_carry else None
    for f in _feats(rng, 3):
        if jcarry is not None:
            wa, jcarry = jax.jit(jad.apply_carry)(jad.params, jnp.asarray(f),
                                                  jcarry)
            ga, pcarry = pad.apply_carry(pad.params, T_(f), pcarry)
            assert sorted(pcarry) == sorted(jcarry)
            for k in jcarry:
                assert_allclose(pcarry[k].numpy(), np.asarray(jcarry[k]),
                                **TOL)
        else:
            wa, ga = jad(jnp.asarray(f)), pad(T_(f))
        assert_allclose(ga.numpy(), np.asarray(wa), **TOL)


def test_unported_policy_raises():
    """Every registry policy of the reference is ported: an unknown name
    raises ``KeyError`` naming the registered set, and a stateful policy
    has no stateless view for training (``policy_call``)."""
    assert sorted(pol.POLICIES) == sorted(jpol.POLICIES)
    with pytest.raises(KeyError, match="registered"):
        pol.build_policy("nope", F, A, E, device="cpu")
    for name in ("rglru", "rwkv6"):
        with pytest.raises(ValueError, match="stateful"):
            jpred.policy_call(jpol.POLICIES[name](F, A))
        with pytest.raises(ValueError, match="stateful"):
            policy_call(pol.build_policy(name, F, A, E, device="cpu"))
    for name in ("linear", "mlp"):
        apply, params = policy_call(pol.build_policy(name, F, A, E,
                                                     device="cpu"))
        assert params and apply(params, torch.zeros((E, F))).shape == (E, A)


@pytest.mark.parametrize("build", [
    pytest.param(lambda **kw: linear_policy(F, A, **kw), id="linear_policy"),
    pytest.param(lambda **kw: pol.linear_builder(F, A, **kw),
                 id="linear_builder"),
    pytest.param(lambda **kw: pol.rglru_builder(F, A, **kw),
                 id="rglru_builder"),
    pytest.param(lambda **kw: pol.mlp_builder(F, A, **kw),
                 id="mlp_builder"),
    pytest.param(lambda **kw: pol.rwkv6_builder(F, A, **kw),
                 id="rwkv6_builder")])
def test_policy_builders_default_to_the_card(build):
    """Like every entry point of the port, the policy builders take
    ``device=None`` as the CUDA card: without one they raise rather than
    land on the CPU; ``device="cpu"`` asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    model = build(device="cpu")
    assert all(p.device.type == "cpu" for p in model.params.values())


SPACE = (np.array([-1.0, -0.5]), np.array([1.0, 0.5]))


def _jax_predictor(capacity):
    model = jpol.rglru_builder(F, A, n_envs=E, hidden=16, seed=5)
    return jpred.Predictor(model, jrw.energy_reward_spec(1, 0, 2),
                           jpred.ActionSpace(*SPACE), E, F,
                           replay_capacity=capacity)


def _port_predictor(jp, capacity):
    params = convert.policy_params_from_numpy(
        "rglru", _np(jp.model.params), "cpu")
    model = pol.rglru_builder(F, A, hidden=16, use_kernel=True,
                              params=params, device="cpu")
    return Predictor(model, rw.energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, F, replay_capacity=capacity,
                     device="cpu")


def test_on_windows_equals_k_on_ticks_bitwise(rng):
    jp = _jax_predictor(5)
    a, b = _port_predictor(jp, 5), _port_predictor(jp, 5)
    for batch in range(2):             # the prev chain crosses batches
        feats, raw = _feats(rng, 4), _feats(rng, 4) * 3.0
        times = [480.0 * (4 * batch + j + 1) for j in range(4)]
        seq = [a.on_tick(T_(feats[j]), times[j], raw=T_(raw[j]))
               for j in range(4)]
        acts, rews, per = b.on_windows(T_(feats), times, raw=T_(raw))
        for j, (sa, sr, sp) in enumerate(seq):
            assert np.array_equal(sa, acts[j])
            assert np.array_equal(sr, rews[j])
            assert np.array_equal(sp, per[j])
    for x, y in zip(a.replay, b.replay):
        assert torch.equal(x, y)
    assert torch.equal(a._model_carry["h"], b._model_carry["h"])
    assert a.stats == b.stats
    assert np.array_equal(a._replay_times, b._replay_times)


def test_predictor_matches_jax(rng):
    """The port Predictor against the JAX one on the same weights and
    features: on_tick, then on_windows, across a ring wraparound."""
    jp = _jax_predictor(4)
    pp = _port_predictor(jp, 4)
    t = 2.0 ** 24
    for j, f in enumerate(_feats(rng, 2)):
        r = f * 2.0
        want = jp.on_tick(jnp.asarray(f), t + 480.0 * j, raw=jnp.asarray(r))
        got = pp.on_tick(T_(f), t + 480.0 * j, raw=T_(r))
        for g, w in zip(got, want):
            assert_allclose(g, w, **TOL)
    feats = _feats(rng, 5)
    times = [t + 480.0 * (2 + j) for j in range(5)]
    want = jp.on_windows(jnp.asarray(feats), times,
                         raw=jnp.asarray(feats * 2.0))
    got = pp.on_windows(T_(feats), times, raw=T_(feats * 2.0))
    for g, w in zip(got, want):
        assert_allclose(g, w, **TOL)
    assert pp.stats == jp.stats
    wexp = jp.export_replay(["a", "b", "c"], "s")
    gexp = pp.export_replay(["a", "b", "c"], "s")
    assert gexp["env_ids"] == wexp["env_ids"]
    for key in ("tick_idx", "version", "valid", "times"):
        assert np.array_equal(gexp[key], wexp[key]), key
    for key in ("obs", "actions", "rewards", "next_obs"):
        assert_allclose(gexp[key], wexp[key], **TOL)
