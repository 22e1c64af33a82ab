"""The port's behavioural policy certificate (``analysis.certify``) and
the gate the sharded fused modes hold it to.

Mirrors ``tests/test_policies.py``'s registry and bad-builder tests and
``tests/test_analysis.py``'s system-gate tests, with the reference's rule
ids: every registry policy certifies and carries its certificate; a
cross-env mean (``env-reduce``), a row-count-dependent rounding
(``env-gemm-rows``), a row-mixing carry and a carry without an env dim
(``carry-env-mix``) and E-sized params (``param-replication``) are
refused, by name. In ``PerceptaSystem`` the env and carry rules bind only
in the sharded fused modes; ``contract_check=False`` opts out.
"""
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis import certify as certify_mod
from repro_torch.analysis.certify import PolicyCertificate, certify_policy
from repro_torch.analysis.contracts import ContractViolation
from repro_torch.core import PipelineConfig
from repro_torch.core.reward import energy_reward_spec
from repro_torch.distribution import sharding as sh
from repro_torch.runtime.policies import (POLICIES, PolicyConfig,
                                          build_policy)
from repro_torch.runtime.predictor import ActionSpace, ModelAdapter, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

F, A, E = 6, 2, 4
STATEFUL = {"rglru", "rwkv6"}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_registry_policy_certifies_with_certificate_attached(name):
    adapter = build_policy(name, F, A, E, device="cpu")
    cert = adapter.certificate
    assert isinstance(cert, PolicyCertificate)
    assert cert.name == name
    assert cert.stateful == (name in STATEFUL)
    want = {"env-reduce", "env-gemm-rows", "param-replication"}
    if name in STATEFUL:
        want.add("carry-env-mix")
    assert set(cert.rules) == want
    assert cert.param_spec and cert.shard_widths == (1, 2)
    assert cert.probe_shapes == ((4, F, A),)
    if name == "rglru":
        assert "'h'" in cert.carry_structure
    if name == "rwkv6":
        assert "'wkv'" in cert.carry_structure


def test_certificate_cache_skips_reprobing():
    certify_mod.clear_cache()
    a = build_policy("mlp", F, A, E, device="cpu")
    t0 = time.perf_counter()
    b = build_policy("mlp", F, A, E, device="cpu")
    assert b.certificate is a.certificate
    assert time.perf_counter() - t0 < 0.5


def test_policy_config_kwargs_flow_to_builder():
    adapter = build_policy(PolicyConfig("rglru", {"hidden": 8}), F, A, E,
                           device="cpu")
    assert adapter.init_carry(E)["h"].shape == (E, 8)
    assert adapter.certificate.stateful


# --------------------------------------------------------------- bad builders
def _mean_builder(n_features, n_actions, n_envs=None, device="cpu"):
    w = torch.ones((n_features, n_actions), device=device) / n_features

    def apply(p, f):
        # centred on the mean over envs: every row reads every other row
        g = f - f.mean(0, keepdim=True)
        return torch.tanh((g[..., :, None] * p["w"]).sum(-2))

    return ModelAdapter(lambda f: apply({"w": w}, f), "mean",
                        params={"w": w}, apply=apply)


def _count_builder(n_features, n_actions, n_envs=None, device="cpu"):
    w = torch.ones((n_features, n_actions), device=device) / n_features

    def apply(p, f):
        # row-wise values, but the rounding moves with the row count
        scale = 1.0 + 1e-6 * f.shape[0]
        return torch.tanh((f[..., :, None] * p["w"]).sum(-2) * scale)

    return ModelAdapter(lambda f: apply({"w": w}, f), "count",
                        params={"w": w}, apply=apply)


def _roll_carry_builder(n_features, n_actions, n_envs=None, device="cpu"):
    w = torch.ones((n_features, n_actions), device=device) / n_features

    def apply_carry(p, f, c):
        # row i's new state takes row i-1's old state: rows mix
        h = torch.roll(c["h"], 1, 0) + (f[..., :, None] * p["w"]).sum(-2)
        return torch.tanh(h), {"h": h}

    return ModelAdapter(None, "roll_carry", params={"w": w},
                        apply_carry=apply_carry,
                        init_carry=lambda e: {"h": torch.zeros(
                            (e, n_actions), device=device)})


def _global_carry_builder(n_features, n_actions, n_envs=None, device="cpu"):
    w = torch.ones((n_features, n_actions), device=device) / n_features

    def apply_carry(p, f, c):
        return torch.tanh((f[..., :, None] * p["w"]).sum(-2)), c

    return ModelAdapter(None, "global_carry", params={"w": w},
                        apply_carry=apply_carry,
                        init_carry=lambda e: {"n": torch.zeros(
                            (n_actions,), device=device)})


def _width_builder(n_features, n_actions, n_envs=None, device="cpu"):
    w = torch.ones((n_features, n_actions), device=device) / n_features

    def apply(p, f):
        # row-wise values, but the rounding moves in a call of 2 rows only
        scale = 1.0 + (1e-6 if f.shape[0] == 2 else 0.0)
        return torch.tanh((f[..., :, None] * p["w"]).sum(-2) * scale)

    return ModelAdapter(lambda f: apply({"w": w}, f), "width",
                        params={"w": w}, apply=apply)


def _env_params_builder(n_features, n_actions, n_envs=4, device="cpu"):
    w = torch.ones((n_envs, n_features, n_actions), device=device)

    def apply(p, f):
        return (f[..., :, None] * p["w"]).sum(-2)

    return ModelAdapter(lambda f: apply({"w": w}, f), "env_params",
                        params={"w": w}, apply=apply)


@pytest.mark.parametrize("builder,rule", [
    (_mean_builder, "env-reduce"),
    (_count_builder, "env-gemm-rows"),
    (_roll_carry_builder, "carry-env-mix"),
    (_global_carry_builder, "carry-env-mix"),
    (_env_params_builder, "param-replication"),
])
def test_bad_builder_rejected_naming_rule(builder, rule):
    with pytest.raises(ContractViolation) as ei:
        certify_policy(builder, name="bad")
    msg = str(ei.value)
    assert f"[{rule}]" in msg
    assert [v.rule for v in ei.value.violations] == [rule]
    # the label names the registry key and the builder, never "<lambda>"
    assert "policy 'bad'" in msg and builder.__name__ in msg


def test_env_params_diagnostic_names_leaf_and_decide_specs():
    with pytest.raises(ContractViolation) as ei:
        certify_policy(_env_params_builder, name="bad-params")
    msg = str(ei.value)
    assert "'w'" in msg and "decide_specs" in msg


def test_partial_builder_diagnostics_name_builder():
    with pytest.raises(ContractViolation) as ei:
        certify_policy(functools.partial(_mean_builder), name="bad-partial")
    head = str(ei.value).splitlines()[0]
    assert "policy 'bad-partial'" in head and "_mean_builder" in head


def test_rules_scope_the_probes():
    """With the env and carry rules off only param replication binds: a
    cross-env mean or a mixing carry certifies (the unsharded fused
    engine may run them)."""
    off = certify_mod.Rules(env=False, carry=False)
    for b in (_mean_builder, _roll_carry_builder):
        cert = certify_policy(b, rules=off)
        assert cert.rules == ("param-replication",)
    with pytest.raises(ContractViolation, match="param-replication"):
        certify_policy(_env_params_builder, rules=off)


# --------------------------------------------------------- the system's gate
def _sources():
    return [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
    ]


def _mini_system(mode, builder, n_envs=4, **kw):
    cfg = PipelineConfig(n_envs=n_envs, n_streams=2, n_ticks=4, tick_s=60.0,
                         max_samples=16)
    model = builder(cfg.n_features, 2, n_envs=n_envs, device="cpu")
    pred = Predictor(model, energy_reward_spec(1, 0, 0),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     n_envs, cfg.n_features, replay_capacity=8,
                     device="cpu")
    return PerceptaSystem([f"b{i}" for i in range(n_envs)], _sources(), cfg,
                          pred, manual_time=True, mode=mode, scan_k=2,
                          device="cpu", **kw)


@pytest.fixture
def two_shards(monkeypatch):
    monkeypatch.setattr(sh, "visible_devices",
                        lambda device: [torch.device(device)] * 2)


@pytest.mark.parametrize("builder,rule", [
    (_mean_builder, "env-reduce"),
    (_roll_carry_builder, "carry-env-mix"),
    (_env_params_builder, "param-replication"),
])
def test_system_gate_refuses_in_sharded_fused(builder, rule, two_shards):
    for mode in ("scan_fused_decide_sharded",
                 "scan_fused_decide_async_sharded"):
        with pytest.raises(ContractViolation) as ei:
            _mini_system(mode, builder)
        assert f"[{rule}]" in str(ei.value)


@pytest.mark.parametrize("builder", [_mean_builder, _roll_carry_builder,
                                     _env_params_builder])
def test_system_gate_env_rules_off_outside_sharded_dispatch(builder,
                                                            two_shards):
    """The same policies run where the decision math is not split: the
    unsharded fused engine, and scan_sharded's host-side consume."""
    for mode in ("scan_fused_decide", "scan_sharded"):
        system = _mini_system(mode, builder)
        assert len(system.run_windows(2)) == 2
        system.stop()
    assert system.policy_certificate is None           # no gate in scan


def test_system_gate_opt_out(two_shards):
    system = _mini_system("scan_fused_decide_sharded", _mean_builder,
                          contract_check=False)
    assert system.policy_certificate is None
    system.stop()


def test_system_gate_accepts_registry_policies_at_true_shapes(two_shards):
    """A registry policy's build certificate stays on the adapter; the
    sharded system certifies it again at its true (E, F, A) and its shard
    width, and runs."""
    system = _mini_system(
        "scan_fused_decide_sharded",
        lambda f, a, n_envs, device: build_policy("rglru", f, a, n_envs,
                                                  device=device),
        n_envs=6)
    cert = system.policy_certificate
    assert cert.probe_shapes == ((6, system.cfg.n_features, 2),)
    assert cert.shard_widths == (3,)
    assert system.predictor.model.certificate.probe_shapes[0][0] == 4
    assert len(system.run_windows(4)) == 4
    system.stop()


@pytest.fixture
def four_shards(monkeypatch):
    monkeypatch.setattr(sh, "visible_devices",
                        lambda device: [torch.device(device)] * 4)


def test_resize_refuses_a_policy_the_new_shard_width_breaks(four_shards):
    """4 slots on 4 logical shards hold 1 row each, which a policy whose
    rounding moves at 2 rows passes; growing the pool to 8 slots puts 2
    rows on each shard, and ``resize`` refuses by rule id before it
    changes anything."""
    system = _mini_system("scan_fused_decide_sharded", _width_builder,
                          elastic=True)
    assert system.policy_certificate.shard_widths == (1,)
    with pytest.raises(ContractViolation, match=r"\[env-gemm-rows\]"):
        system.resize()
    assert system.env_slots == 4 and system.mesh.size == 4
    assert system.policy_certificate.shard_widths == (1,)
    assert len(system.run_windows(2)) == 2
    system.stop()


def test_resize_replaces_the_certificate(four_shards):
    """A policy that passes at the new width gets the new mesh's
    certificate: the grown E and its shard width."""
    system = _mini_system(
        "scan_fused_decide_sharded",
        lambda f, a, n_envs, device: build_policy("rglru", f, a, n_envs,
                                                  device=device),
        elastic=True)
    assert system.policy_certificate.shard_widths == (1,)
    assert system.resize() == 8
    cert = system.policy_certificate
    assert cert.probe_shapes == ((8, system.cfg.n_features, 2),)
    assert cert.shard_widths == (2,)
    assert len(system.run_windows(2)) == 2
    system.stop()
