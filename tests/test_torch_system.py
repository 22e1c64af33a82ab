"""The port's PerceptaSystem against the JAX one, end to end, plus the
port's package boundary and its device and dtype rules.

Both systems run in ONE process on the same sources and seeds (the
simulated readings hash Python strings, which vary between processes),
with ``manual_time=True``. Tolerances: window index, record counts, the
observed/filled fractions, anomaly counts, forwarder and LogDB row counts,
anonymized ids, tick indices and float64 times exactly; floats that ride
the normalizer stats and the recurrence through up to 6 windows at
rtol = atol = 1e-4 (drift builds up across windows).
"""
import os
import subprocess
import sys

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
from repro_torch.core.reward import energy_reward_spec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.harmonize import ops as hz_ops
from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.window_agg import ops as wagg_ops
from repro_torch.runtime.db import LogDB
from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
from repro_torch.runtime.policies import rglru_builder
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

TOL = dict(rtol=1e-4, atol=1e-4)
E = 3
SPACE = (np.array([-1.0, -1.0]), np.array([1.0, 1.0]))
PCFG = dict(n_envs=E, n_streams=3, n_ticks=8, tick_s=60.0, max_samples=32,
            gap_strategy="locf", feature_agg="mean", k_sigma=4.0)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _sources(spec, device):
    # examples/serve_edge.py's three sources
    return [
        spec("meter", "mqtt", device("grid_kw", 60.0, base=3.0, seed=1)),
        spec("price", "http", device("price_eur", 300.0, base=0.2,
                                     amplitude=0.05, seed=2)),
        spec("thermo", "amqp", device("temp_c", 30.0, base=21.0,
                                      amplitude=1.5, seed=3)),
    ]


def _hub(fwd, hub):
    return hub([fwd("hvac", "mqtt", [0]), fwd("ev-charger", "amqp", [1])])


def _systems(mode, tmp_path, t0=0.0, **kw):
    envs = [f"bldg-{i}" for i in range(E)]
    jcfg = JaxConfig(use_pallas=True, **PCFG)
    model = jpol.rglru_builder(3, 2, n_envs=E, hidden=16, seed=4)
    jpred = JaxPredictor(model, jax_energy(1, 0, 2), JaxSpace(*SPACE), E,
                         jcfg.n_features, replay_capacity=16)
    jsys = JaxSystem(envs, _sources(JaxSource, JaxDevice), jcfg, jpred,
                     forwarders=_hub(JaxForwarder, JaxHub),
                     db=JaxLogDB(str(tmp_path / "jax"), salt="s"),
                     mode=mode, t0=t0, manual_time=True, scan_k=3, **kw)
    cfg = PipelineConfig(use_kernel=True, **PCFG)
    params = convert.policy_params_from_numpy(
        "rglru", jax.tree.map(np.asarray, model.params), "cpu")
    pmodel = rglru_builder(3, 2, hidden=16, use_kernel=True, params=params,
                           device="cpu")
    pred = Predictor(pmodel, energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, cfg.n_features,
                     replay_capacity=16, device="cpu")
    psys = PerceptaSystem(envs, _sources(SourceSpec, SimulatedDevice), cfg,
                          pred, forwarders=_hub(Forwarder, ForwarderHub),
                          db=LogDB(str(tmp_path / "port"), salt="s"),
                          mode=mode, t0=t0, manual_time=True, scan_k=3,
                          device="cpu", **kw)
    return jsys, psys


@pytest.mark.parametrize("mode", ["fused", "scan", "scan_fused_decide",
                                  "scan_async", "scan_fused_decide_async"])
def test_system_matches_jax(mode, tmp_path):
    jsys, psys = _systems(mode, tmp_path, t0=2.0 ** 24)
    want, got = jsys.run_windows(6), psys.run_windows(6)
    assert len(got) == 6
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            if key == "mean_reward":
                assert_allclose(g[key], w[key], **TOL)
            elif key != "latency_s":
                assert g[key] == w[key], key
    assert sum(g["anomalous"] for g in got) + \
        sum(g["filled_frac"] for g in got) > 0
    for fj, fp in zip(jsys.forwarders.forwarders, psys.forwarders.forwarders):
        assert fp.stats["sent"] == fj.stats["sent"] == 6 * E
    jrows = [r for _, r in jsys.db.read_from()]
    prows = [r for _, r in psys.db.read_from()]
    assert len(prows) == len(jrows) == 6 * E
    for pr, jr in zip(prows, jrows):
        assert (pr["env"], pr["t"], pr["policy_version"]) == \
            (jr["env"], jr["t"], jr["policy_version"])
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


@pytest.mark.parametrize("fastpath,workers,ingest", [
    (True, 1, "columnar"), (True, 2, "columnar"), (False, 1, "columnar"),
    (True, 1, "records")])
def test_host_ingest_assembles_identical_batches(fastpath, workers, ingest,
                                                 tmp_path):
    """The copied host ingest modules give byte-identical staged batches."""
    jsys, psys = _systems("scan", tmp_path, ingest_fastpath=fastpath,
                          ingest_workers=workers, ingest=ingest)
    for sys_ in (jsys, psys):
        bounds = [sys_.window_bounds(j) for j in range(3)]
        sys_._advance_clock(bounds[-1][1])
        sys_.pump_receivers()
    bounds = [psys.window_bounds(j) for j in range(3)]
    (jraw, jcounts), (praw, pcounts) = (jsys.assemble_windows(bounds),
                                        psys.assemble_windows(bounds))
    assert pcounts == jcounts and sum(pcounts) > 0
    for p, j in zip(praw, jraw):
        j = np.asarray(j)
        assert p.numpy().dtype == j.dtype
        assert p.numpy().tobytes() == j.tobytes()
    assert psys.stats()["queues"] == jsys.stats()["queues"]
    jsys.stop()
    psys.stop()


def test_port_imports_neither_jax_nor_repro():
    # mind that "repro_torch" itself starts with "repro"
    code = ("import sys; import repro_torch, repro_torch.convert, "
            "repro_torch.runtime.system, repro_torch.runtime.prefetch, "
            "repro_torch.runtime.trainer, repro_torch.train.checkpoint, "
            "repro_torch.distribution.elastic, "
            "repro_torch.distribution.sharding, repro_torch.core.autotune, "
            "repro_torch.analysis.certify, "
            "repro_torch.models, "
            "repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.configs.registry, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.harmonize.ops; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; "
            "assert not bad, bad; print('CLEAN')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = PipelineConfig(**PCFG)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor("linear", energy_reward_spec(1, 0, 2),
                  ActionSpace(*SPACE), E, cfg.n_features)
    pred = Predictor("linear", energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, cfg.n_features, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PerceptaSystem([f"e{i}" for i in range(E)],
                       _sources(SourceSpec, SimulatedDevice), cfg, pred)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="scan", train="online"), "rides the fused decide carry"),
    (dict(elastic=True), "scan engine"),
    (dict(train="online"), "rides the fused decide carry"),
    (dict(mode="scan_fused_decide", train="online", policy="rwkv6"),
     "stateful"),
    (dict(mode="scan_fused_decide", train="online", policy="rglru"),
     "stateful"),
    (dict(mode="scan_fused_decide", train="offline"), "unknown train mode"),
])
def test_unported_options_raise(kw, match):
    """Options the port refuses, as the reference does: training outside
    the fused-decide modes, an elastic pool on the per-window engine, a
    stateful policy with training, an unknown train mode."""
    cfg = PipelineConfig(**PCFG)
    pred = Predictor("linear", energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, cfg.n_features, device="cpu")
    with pytest.raises(ValueError, match=match):
        PerceptaSystem([f"e{i}" for i in range(E)],
                       _sources(SourceSpec, SimulatedDevice), cfg, pred,
                       device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(mode="scan_sharded"), dict(mode="scan_async_sharded"),
    dict(mode="scan_fused_decide_sharded"),
    dict(mode="scan_fused_decide_async_sharded"),
    dict(mode="scan", scan_k="auto",
         autotune=dict(k_grid=(1, 2), reps=1)),
    dict(mode="scan_fused_decide_sharded", scan_k="auto",
         autotune=dict(k_grid=(1, 2), reps=1)),
])
def test_sharded_modes_and_autotune_run(kw, tmp_path):
    """The four sharded modes and ``scan_k="auto"`` build and run (their
    results are held bit for bit against the unsharded twins in
    ``test_torch_sharded.py``)."""
    cfg = PipelineConfig(**PCFG)
    pred = Predictor("linear", energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, cfg.n_features,
                     replay_capacity=8, device="cpu")
    system = PerceptaSystem([f"e{i}" for i in range(E)],
                            _sources(SourceSpec, SimulatedDevice), cfg, pred,
                            manual_time=True, device="cpu",
                            **dict({"scan_k": 2}, **kw))
    try:
        got = system.run_windows(3)
    finally:
        system.stop()
    assert [r["window"] for r in got] == [0, 1, 2]
    assert all(np.isfinite(r["mean_reward"]) for r in got)
    if kw.get("scan_k") == "auto":
        assert system.scan_k == system.tuned.scan_k in (1, 2)


def test_unknown_policy_raises():
    cfg = PipelineConfig(**PCFG)
    pred = Predictor("linear", energy_reward_spec(1, 0, 2),
                     ActionSpace(*SPACE), E, cfg.n_features, device="cpu")
    with pytest.raises(KeyError, match="Unrecognized policy"):
        PerceptaSystem([f"e{i}" for i in range(E)],
                       _sources(SourceSpec, SimulatedDevice), cfg, pred,
                       device="cpu", policy="nope")


def test_ops_raise_on_unsupported_dtype():
    """No wrapper falls back. flash_attention takes float32, bfloat16 and
    float16 and raises on float64 before any dispatch. The other four op
    entries take every dtype the reference's take (values cast to
    float32, masks read as ``> 0``): a float64 input and an int mask give
    the float32/bool call's result, nothing raises."""
    f64 = torch.zeros((2, 2, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(f64[None], f64[None], f64[None])
    v = torch.arange(16, dtype=torch.float64).reshape(2, 2, 4) - 5
    b = (v > 0)
    c = torch.ones((2, 2), dtype=torch.float64)
    want = locf_ops.locf(v.float(), b, c.float(), c > 0)
    got = locf_ops.locf(v, b.int() - (~b).int(), c, c.int())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = wagg_ops.window_agg(v.float(), b, c.float(), c.float())
    got = wagg_ops.window_agg(v, b.int(), c, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    h0 = v[:, 0]
    want = rglru_ops.rglru_scan(v.float(), v.float(), h0.float())
    got = rglru_ops.rglru_scan(v, v, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ws = torch.zeros((2,), dtype=torch.float64)
    want = hz_ops.harmonize(v.float(), v.abs().float(), b, ws.float(),
                            tick_s=1.0, n_ticks=4)
    got = hz_ops.harmonize(v, v.abs(), b.int() - (~b).int(), ws,
                           tick_s=1.0, n_ticks=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
