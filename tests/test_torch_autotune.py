"""The port's ``core.autotune`` against the JAX package's, and
``PerceptaSystem(scan_k="auto")``.

Under one injected ``measure`` (which never runs the cell) both tuners
must return the same ``TuneResult``: grid in measure order, pruned cells
with their reasons, the choice, and the same error when every split is
pruned; with the default ``measure`` the port times real batches of its
engines (the CPU here; logical shards for the splits). Mirrors
``tests/test_scan_async.py``'s autotuner tests.
"""
import numpy as np
import pytest
import torch

from repro.core import PipelineConfig as JaxConfig
from repro.core import autotune as jtune
from repro_torch.core import PipelineConfig
from repro_torch.core import autotune as tune
from repro_torch.core.reward import energy_reward_spec
from repro_torch.distribution import sharding as sh
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec
from repro_torch.train import tree

SHAPE = dict(n_streams=2, n_ticks=8, tick_s=60.0, max_samples=32)


@pytest.fixture
def logical(monkeypatch):
    def use(n):
        monkeypatch.setattr(sh, "visible_devices",
                            lambda device: [torch.device(device)] * n)
    return use


def _fake_measure(fn, *, k, n_devices, reps=3):
    """Deterministic synthetic timer: never runs fn, prefers K=4."""
    return {2: 0.004, 4: 0.006, 8: 0.020}[k] * n_devices


def _both(n_envs, **kw):
    """The same call to both tuners (the port on the CPU)."""
    got = tune.tune_scan_params(PipelineConfig(n_envs=n_envs, **SHAPE),
                                device="cpu", **kw)
    want = jtune.tune_scan_params(JaxConfig(n_envs=n_envs, **SHAPE), **kw)
    return got, want


def test_same_result_as_jax_under_a_fixed_measure():
    got, want = _both(2, k_grid=(2, 4, 8), device_counts=[1],
                      measure=_fake_measure)
    assert tuple(got) == tuple(want)
    assert isinstance(got, tune.TuneResult)
    # windows/s argmax of the synthetic grid: 4/0.006 > 8/0.020 > 2/0.004
    assert got.scan_k == 4 and got.mesh_devices == 1
    assert got.best_windows_per_s == max(w for _, _, w in got.grid)
    assert got.as_dict() == want.as_dict()
    assert got == tune.tune_scan_params(PipelineConfig(n_envs=2, **SHAPE),
                                        k_grid=(2, 4, 8), device_counts=[1],
                                        measure=_fake_measure, device="cpu")


def test_candidate_device_counts_divisibility():
    for e, n in ((8, 8), (6, 4), (12, 5), (7, 3)):
        assert tune.candidate_device_counts(e, n) == \
            jtune.candidate_device_counts(e, n)
    assert tune.candidate_device_counts(8, 8) == [1, 2, 4, 8]


def test_floor_prunes_starved_splits_as_jax(logical):
    """Splits below ``min_envs_per_device`` never measure, and are listed
    on ``pruned``; relaxing the floor restores them. On 8 logical shards
    the port's cells really split."""
    logical(8)
    for kw in (dict(k_grid=(2, 4), device_counts=[1, 4, 8]),
               dict(k_grid=(2,), device_counts=[1, 8],
                    min_envs_per_device=1)):
        calls = []

        def measure(fn, *, k, n_devices, reps=3):
            calls.append((k, n_devices))
            return 0.001 * k

        got = tune.tune_scan_params(PipelineConfig(n_envs=8, **SHAPE),
                                    measure=measure, device="cpu", **kw)
        port_calls, calls[:] = list(calls), []
        want = jtune.tune_scan_params(JaxConfig(n_envs=8, **SHAPE),
                                      measure=measure, **kw)
        assert tuple(got) == tuple(want)
        assert port_calls == calls
    assert (None, 8, "envs_per_device<2") in tune.tune_scan_params(
        PipelineConfig(n_envs=8, **SHAPE), k_grid=(2,),
        device_counts=[1, 8], measure=lambda fn, **_: 0.01,
        device="cpu").pruned


def test_early_stop_of_far_off_splits_as_jax(logical):
    """A cell > prune_factor x slower than the incumbent stops the rest of
    its split's K column, in both tuners alike."""
    logical(2)

    def measure(fn, *, k, n_devices, reps=3):
        if n_devices == 2:
            return 1.0          # 2 w/s at k=2: a hopeless split
        return {2: 0.004, 4: 0.006}[k]

    got, want = _both(4, k_grid=(2, 4), device_counts=[1, 2],
                      measure=measure)
    assert tuple(got) == tuple(want)
    assert {(k, n) for k, n, _ in got.grid} == {(2, 1), (4, 1), (2, 2)}
    assert got.pruned == ((4, 2, ">3x_off_incumbent"),)
    assert got.scan_k == 4 and got.mesh_devices == 1


def test_every_split_pruned_raises_as_jax():
    kw = dict(k_grid=(2,), device_counts=[4], measure=_fake_measure)
    with pytest.raises(ValueError) as got:
        tune.tune_scan_params(PipelineConfig(n_envs=4, **SHAPE),
                              device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jtune.tune_scan_params(JaxConfig(n_envs=4, **SHAPE), **kw)
    assert str(got.value) == str(want.value)
    assert "every requested mesh split was pruned" in str(got.value)


def test_default_measure_times_real_batches(logical):
    """The default ``measure`` runs the engines: the plain and the sharded
    scan engine on 2 logical shards, every cell a positive windows/s, the
    choice the grid's argmax."""
    logical(2)
    cfg = PipelineConfig(n_envs=4, **dict(SHAPE, n_ticks=4,
                                          max_samples=16))
    res = tune.tune_scan_params(cfg, k_grid=(2, 4), reps=1, device="cpu",
                                prune_factor=1e9)
    assert {(k, n) for k, n, _ in res.grid} == {(2, 1), (4, 1), (2, 2),
                                                (4, 2)}
    assert all(w > 0 for _, _, w in res.grid)
    assert res.best_windows_per_s == max(w for _, _, w in res.grid)


def _predictor(n_envs, capacity=8):
    cfg = PipelineConfig(n_envs=n_envs, **dict(SHAPE, n_ticks=4,
                                               max_samples=16))
    pred = Predictor("linear", energy_reward_spec(price_idx=1, grid_idx=0,
                                                  temp_idx=0),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     n_envs, cfg.n_features, replay_capacity=capacity,
                     device="cpu")
    return cfg, pred


@pytest.mark.parametrize("shards", [1, 2])
def test_fused_grid_leaves_the_callers_carry_untouched(shards, logical):
    """With ``decide=``/``decide_state=`` every cell runs the fused engine
    (sharded on 2 logical shards) on clones: the engine writes the ring in
    place, yet the caller's carry keeps its bits."""
    logical(shards)
    cfg, pred = _predictor(2)
    dstate = pred.decide_state()
    before = tree.map_(lambda x: x.clone(), dstate)
    res = tune.tune_scan_params(cfg, k_grid=(2, 4), reps=1, device="cpu",
                                decide=pred.make_decide_fn(),
                                decide_state=dstate, min_envs_per_device=1)
    assert {n for _, n, _ in res.grid} == set(range(1, shards + 1))
    assert all(w > 0 for _, _, w in res.grid)
    for x, y in zip(tree.leaves(before), tree.leaves(dstate)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="pair"):
        tune.tune_scan_params(cfg, decide=pred.make_decide_fn(),
                              device="cpu")


def _system(mode, n_envs=2, scan_k=3, **kw):
    srcs = [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
    ]
    cfg, pred = _predictor(n_envs)
    return PerceptaSystem([f"b{i}" for i in range(n_envs)], srcs, cfg, pred,
                          speedup=5000.0, manual_time=True, mode=mode,
                          scan_k=scan_k, device="cpu", **kw)


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


@pytest.mark.parametrize("mode", ["scan_async", "scan_fused_decide"])
def test_system_scan_k_auto_runs_the_tuned_k(mode):
    """``scan_k="auto"`` picks the measured optimum and the tuned system
    equals the scan reference at that K, bit for bit."""
    system = _system(mode, scan_k="auto",
                     autotune=dict(k_grid=(2, 4, 8), measure=_fake_measure))
    assert system.scan_k == 4 and system.tuned.scan_k == 4
    assert system.tuned.grid == tuple(
        (k, 1, k / _fake_measure(None, k=k, n_devices=1))
        for k in (2, 4, 8))
    ref = _strip(_system("scan", scan_k=4).run_windows(5))
    assert _strip(system.run_windows(5)) == ref
    system.stop()


def test_system_scan_k_auto_chooses_the_mesh(logical):
    """In a sharded mode the tuned split is the mesh's: the fake measure
    prefers 2 of 4 logical shards, and the system runs on 2, equal to the
    unsharded system bit for bit."""
    logical(4)

    def measure(fn, *, k, n_devices, reps=3):
        return 0.01 * k * (1.0 if n_devices == 2 else 3.0)

    system = _system("scan_fused_decide_sharded", n_envs=4, scan_k="auto",
                     autotune=dict(k_grid=(2, 4), measure=measure,
                                   min_envs_per_device=1))
    assert system.tuned.mesh_devices == 2 and system.mesh.size == 2
    assert system.tuned.as_dict()["grid"][0] == {
        "scan_k": 2, "mesh_devices": 1, "windows_per_s": 33.3}
    ref = _strip(_system("scan_fused_decide", n_envs=4,
                         scan_k=system.scan_k).run_windows(5))
    assert _strip(system.run_windows(5)) == ref
    system.stop()
