"""The port's async Manager loops (``scan_async``, ``scan_fused_decide_async``)
and its ``runtime.prefetch.WindowPrefetcher``, mirroring
``tests/test_scan_async.py``.

The pump thread runs exactly the synchronous clock-advance/poll/drain
sequence at the same window boundaries, so every per-window field except
the wall-clock ``latency_s`` must equal the synchronous twin's exactly, and
so must the forwarder sinks, queue stats and the replay export. The
prefetcher's errors re-raise in the Manager thread at the handoff.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import PipelineConfig
from repro_torch.core.reward import energy_reward_spec
from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
from repro_torch.runtime.predictor import (ActionSpace, Predictor,
                                            linear_policy)
from repro_torch.runtime.prefetch import WindowPrefetcher
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec

TWINS = [("scan_async", "scan"),
         ("scan_fused_decide_async", "scan_fused_decide")]


def _system(mode, n_envs=2, scan_k=3):
    srcs = [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
    ]
    cfg = PipelineConfig(n_envs=n_envs, n_streams=2, n_ticks=8, tick_s=60.0,
                         max_samples=32, feature_agg="mean", use_kernel=True)
    pred = Predictor(linear_policy(2, 2, device="cpu"),
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0),
                     ActionSpace(np.array([-1., -1.]), np.array([1., 1.])),
                     n_envs, cfg.n_features, replay_capacity=64,
                     device="cpu")
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev", "amqp", [1])])
    return PerceptaSystem([f"bldg-{i}" for i in range(n_envs)], srcs, cfg,
                          pred, forwarders=hub, speedup=5000.0,
                          manual_time=True, mode=mode, scan_k=scan_k,
                          device="cpu")


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


@pytest.mark.parametrize("async_mode,twin", TWINS)
def test_async_matches_its_synchronous_twin(async_mode, twin):
    # 7 windows over scan_k = 3: two full batches and a ragged one, so the
    # handoff covers the tail too
    ref, got = _system(twin), _system(async_mode)
    assert _strip(got.run_windows(7)) == _strip(ref.run_windows(7))
    for fa, fb in zip(ref.forwarders.forwarders, got.forwarders.forwarders):
        assert fa.sink == fb.sink and fa.stats == fb.stats
    assert ref.predictor.stats == got.predictor.stats
    ea, eb = ref.export_replay("s"), got.export_replay("s")
    for key in ea:
        assert np.array_equal(ea[key], eb[key]), key
    got.stop()
    assert got._prefetcher._thread is None      # stop() stops the pump
    ref.stop()


@pytest.mark.parametrize("async_mode,twin", TWINS)
def test_async_chained_calls_resume_epochs(async_mode, twin):
    """A second run_windows call reuses the pump thread and stays aligned."""
    a, b = _system(twin), _system(async_mode)
    ra = a.run_windows(3) + a.run_windows(4)
    rb = b.run_windows(3) + b.run_windows(4)
    assert [r["window"] for r in rb] == list(range(7))
    assert _strip(ra) == _strip(rb)
    assert a.stats()["queues"] == b.stats()["queues"]
    a.stop()
    b.stop()


@pytest.mark.parametrize("async_mode", [m for m, _ in TWINS])
def test_system_surfaces_pump_thread_failure(async_mode, monkeypatch):
    sys_ = _system(async_mode)

    def boom(bounds):
        raise RuntimeError("accumulator corrupt")

    monkeypatch.setattr(sys_, "assemble_windows", boom)
    with pytest.raises(RuntimeError, match="accumulator corrupt"):
        sys_.run_windows(3)
    # the prefetcher stays failed: nothing is retried
    with pytest.raises(RuntimeError, match="prefetcher failed"):
        sys_.run_windows(3)
    sys_.stop()


def test_prefetcher_exception_propagates_to_manager():
    calls = []

    def assemble(bounds, pump):
        calls.append(bounds)
        if len(calls) == 2:
            raise ValueError("drain exploded")
        return ("raw", list(bounds)), [0] * len(bounds)

    pf = WindowPrefetcher(assemble)
    pf.submit([(0.0, 1.0)])
    pf.submit([(1.0, 2.0)])
    first = pf.next_batch()
    assert first.epoch == 0 and first.counts == [0]
    with pytest.raises(ValueError, match="drain exploded"):
        pf.next_batch()
    with pytest.raises(RuntimeError):
        pf.submit([(2.0, 3.0)])
    pf.stop()


def test_prefetcher_epoch_order_and_backpressure():
    order = []
    gate = threading.Event()

    def assemble(bounds, pump):
        order.append(bounds[0][0])
        gate.wait(5.0)
        return ("raw", bounds[0][0]), [1]

    pf = WindowPrefetcher(assemble, depth=1)
    for j in range(4):
        pf.submit([(float(j), float(j) + 1.0)], pump=False)
    # depth 1: with the gate shut the pump holds one batch in hand and at
    # most one in the buffer, so at most two plans have started
    time.sleep(0.3)
    assert len(order) <= 2
    gate.set()
    got = [pf.next_batch() for _ in range(4)]
    assert [b.epoch for b in got] == [0, 1, 2, 3]
    assert order == [0.0, 1.0, 2.0, 3.0]
    pf.stop()


def test_prefetcher_stop_with_abandoned_batches_and_restart():
    """A Manager that abandons its batches must not wedge stop() on the
    full ready buffer, and a later submit() starts from a clean handoff."""
    assembled = []

    def assemble(bounds, pump):
        assembled.append(bounds[0][0])
        return ("raw", bounds[0][0]), [1]

    pf = WindowPrefetcher(assemble, depth=1)
    for j in range(4):            # never consumed: the pump fills the buffer
        pf.submit([(float(j), float(j) + 1.0)], pump=False)
    t0 = time.time()
    pf.stop()
    assert time.time() - t0 < 5.0
    assert pf._thread is None
    n_before = len(assembled)
    pf.submit([(100.0, 101.0)], pump=False)
    got = pf.next_batch()
    assert got.epoch == 0 and got.raw == ("raw", 100.0)
    assert assembled[n_before:] == [100.0]
    pf.stop()
