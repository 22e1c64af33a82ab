"""Drive the PyTorch/CUDA port's decision loop once on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
     versions; the card must be compute capability 9.0 (Hopper).
  2. build   — every CUDA kernel compiled from the repository's sources.
  3. kernels — each kernel against its plain PyTorch version on the card,
     at the decision path's shapes and at a fleet shape, with times from
     CUDA events (median of single launches).
  4. scan    — the port's PerceptaSystem in ``scan`` mode at E=256 envs,
     S=8 sources, K=32 windows per batch, replay capacity 4096, the rglru
     policy: 4 batches (128 windows) with every kernel launch counted.
  5. fused   — the same system in ``fused`` mode for 32 windows, equal bit
     for bit to the first 32 windows of a fresh ``scan`` run.
The line before the last holds one JSON object with every kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``. Without a
card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
E, K, BATCHES, CAPACITY = 256, 32, 4, 4096
N_TICKS, TICK_S, MAX_SAMPLES, HIDDEN = 8, 60.0, 32, 16


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------- timing
def call_ms(fn, reps=50, warmup=5):
    """Median time of one call from issue to completion: a CUDA event pair
    around each call. For a small kernel this is the host's launch path
    (argument checks, ctypes, the launch) more than the kernel itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_us(events):
    """Summed duration of the device activity (kernels, copies) among
    profiler events, in microseconds."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "self_device_time_total", 0)
               for e in events if e.device_type == DeviceType.CUDA)


def device_ms(fn, reps=20, warmup=3):
    """Device time of one call: the card's busy time (every kernel the call
    launched, gaps between them excluded), from the profiler's CUPTI trace,
    averaged over ``reps`` calls. None when the trace holds no device
    activity (the caller then reports event times)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = _device_us(prof.key_averages())
    return total / reps / 1e3 if total > 0 else None


def bound(bytes_moved, ops):
    """Least time the card could take: the larger of bytes over the HBM
    rate and float32 operations over the non-tensor-core float32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- kernels
def kernel_cases(dev, g):
    """(name, shape label, kernel call, plain call, compare, bytes, ops,
    library call or None) at the path's shapes and a fleet shape."""
    from repro_torch.kernels.locf import ops as locf_ops
    from repro_torch.kernels.locf.ref import locf_ref
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.window_agg import ops as wagg_ops
    from repro_torch.kernels.window_agg.ref import window_agg_ref

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def mask(p, *shape):
        return torch.rand(shape, generator=g, device=dev) < p

    cases = []
    # E*S rows x T ticks: the path (E=256, S=8, n_ticks=8) and a fleet
    # (4096 envs x 8 streams, 64 ticks)
    for label, (e, s, t) in (("path", (E, 8, N_TICKS)),
                             ("fleet", (4096, 8, 64))):
        R = e * s
        v, o, iv, ih = rnd(e, s, t), mask(0.6, e, s, t), rnd(e, s), \
            mask(0.5, e, s)

        def locf_cmp(v=v, o=o, iv=iv, ih=ih, R=R, t=t):
            out, has = locf_ops.locf(v, o, iv, ih)
            ref_v, ref_h = locf_ref(v.reshape(R, t), o.reshape(R, t),
                                    iv.reshape(R), ih.reshape(R))
            out, has = out.reshape(R, t), has.reshape(R, t)
            check(torch.equal(has, ref_h), "locf: has differs")
            check(torch.equal(out[ref_h], ref_v[ref_h]),
                  "locf: filled values differ where has is True")
            return (out[ref_h] - ref_v[ref_h]).abs().max().item()

        cases.append(dict(
            name="locf", shape=label, dims=dict(R=R, T=t),
            kernel=lambda v=v, o=o, iv=iv, ih=ih: locf_ops.locf(v, o, iv,
                                                                 ih),
            plain=lambda v=v, o=o, iv=iv, ih=ih, R=R, t=t: locf_ref(
                v.reshape(R, t), o.reshape(R, t), iv.reshape(R),
                ih.reshape(R)),
            compare=locf_cmp,
            # read values + observed + carry, write filled + has
            bytes=R * t * 5 + R * 5 + R * t * 5, ops=0, library=None))

        w = 5.0 + 2.0 * rnd(e, s, t)
        m = mask(0.7, e, s, t)
        mu, var = 5.0 + rnd(e, s), 1.0 + rnd(e, s).abs()

        def wagg_cmp(w=w, m=m, mu=mu, var=var, R=R, t=t):
            stats, spikes = wagg_ops.window_agg(w, m, mu, var, k_sigma=1.5)
            ref_s, ref_sp = window_agg_ref(w.reshape(R, t), m.reshape(R, t),
                                           mu.reshape(R), var.reshape(R),
                                           1.5)
            stats = stats.reshape(R, 8)
            exact = [2, 3, 4, 5, 7]   # min, max, last, count, n_spikes
            check(torch.equal(spikes.reshape(R, t), ref_sp),
                  "window_agg: spikes differ")
            check(torch.equal(stats[:, exact], ref_s[:, exact]),
                  "window_agg: exact stats differ")
            torch.testing.assert_close(stats[:, [0, 1, 6]],
                                       ref_s[:, [0, 1, 6]], rtol=1e-5,
                                       atol=1e-5)
            return (stats - ref_s).abs().max().item()

        cases.append(dict(
            name="window_agg", shape=label, dims=dict(R=R, T=t),
            kernel=lambda w=w, m=m, mu=mu, var=var: wagg_ops.window_agg(
                w, m, mu, var, k_sigma=1.5),
            plain=lambda w=w, m=m, mu=mu, var=var, R=R, t=t: window_agg_ref(
                w.reshape(R, t), m.reshape(R, t), mu.reshape(R),
                var.reshape(R), 1.5),
            compare=wagg_cmp,
            # read values + mask + (mean, var), write 8 stats + spikes;
            # ~11 float32 operations per element over the two passes
            bytes=R * t * 5 + R * 8 + R * 8 * 4 + R * t,
            ops=11 * R * t, library=None))

    # B x T x W: the path (B=E, T=1, W=hidden), a fleet step (4096 envs)
    # and a long sequence (64 x 1024 x 256)
    for label, (b_, t, w_) in (("path", (E, 1, HIDDEN)),
                               ("fleet", (4096, 1, HIDDEN)),
                               ("sequence", (64, 1024, 256))):
        a = torch.rand((b_, t, w_), generator=g, device=dev) * 0.5 + 0.5
        b, h0 = rnd(b_, t, w_), rnd(b_, w_)

        def rg_cmp(a=a, b=b, h0=h0):
            hs, h = rglru_ops.rglru_scan(a, b, h0)
            ref_hs, ref_h = rglru_scan_ref(a, b, h0)
            check(torch.equal(hs, ref_hs) and torch.equal(h, ref_h),
                  "rglru_scan: differs from a*h + b")
            return (hs - ref_hs).abs().max().item()

        lib = None
        if t == 1:   # one step: b + a*h in one PyTorch call
            lib = lambda a=a, b=b, h0=h0: torch.addcmul(b[:, 0], a[:, 0], h0)
        n = b_ * t * w_
        cases.append(dict(
            name="rglru_scan", shape=label, dims=dict(B=b_, T=t, W=w_),
            kernel=lambda a=a, b=b, h0=h0: rglru_ops.rglru_scan(a, b, h0),
            plain=lambda a=a, b=b, h0=h0: rglru_scan_ref(a, b, h0),
            compare=rg_cmp,
            # read a, b, h0, write hs and h_last; a multiply and an add
            bytes=n * 12 + b_ * w_ * 8, ops=2 * n, library=lib))
    return cases


KERNEL_META = {
    "locf": ("src/repro_torch/kernels/locf/csrc/locf.cu",
             "src/repro/kernels/locf/kernel.py:36"),
    "window_agg": ("src/repro_torch/kernels/window_agg/csrc/window_agg.cu",
                   "src/repro/kernels/window_agg/kernel.py:59"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:35"),
}


def phase_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    at_path = {}
    for case in kernel_cases(dev, g):
        err = case["compare"]()
        reps = 20 if case["shape"] == "sequence" else 50
        calls = {k: call_ms(case[k], reps=reps) for k in
                 ("kernel", "plain", "library") if case[k] is not None}
        dev_ms = {k: device_ms(case[k]) for k in calls}
        timer = "profiler" if all(v is not None
                                  for v in dev_ms.values()) else "events"
        t = dev_ms if timer == "profiler" else calls
        ms, plain_ms, lib_ms = t["kernel"], t["plain"], t.get("library")
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        us = lambda x: None if x is None else x * 1e3
        emit(dict(kernel=case["name"], shape=case["shape"], **case["dims"],
                  parity="ok", max_abs_err=err, timer=timer, us=us(ms),
                  plain_us=us(plain_ms), library_us=us(lib_ms),
                  bound_us=us(bound_ms), bound_by=bound_by,
                  call_us=us(calls["kernel"]),
                  plain_call_us=us(calls["plain"]),
                  library_call_us=us(calls.get("library"))))
        if case["shape"] == "path":
            at_path[case["name"]] = dict(
                max_abs_err=err, timer=timer, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    return at_path


# --------------------------------------------------------------- system
def make_system(mode, dev, db_dir):
    from repro_torch.core import PipelineConfig
    from repro_torch.core.reward import energy_reward_spec
    from repro_torch.runtime.db import LogDB
    from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
    from repro_torch.runtime.policies import PolicyConfig
    from repro_torch.runtime.predictor import ActionSpace, Predictor
    from repro_torch.runtime.receivers import SimulatedDevice
    from repro_torch.runtime.system import PerceptaSystem, SourceSpec

    sources = [   # examples/serve_edge.py's three, plus five more devices
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
        SourceSpec("thermo", "amqp", SimulatedDevice(
            "temp_c", 30.0, base=21.0, amplitude=1.5, seed=3)),
        SourceSpec("pv", "mqtt", SimulatedDevice("pv_kw", 30.0, base=2.0,
                                                 amplitude=2.0, seed=4)),
        SourceSpec("ev", "amqp", SimulatedDevice("ev_kw", 60.0, base=7.0,
                                                 seed=5)),
        SourceSpec("humid", "http", SimulatedDevice(
            "humidity", 120.0, base=45.0, amplitude=5.0, seed=6)),
        SourceSpec("co2", "mqtt", SimulatedDevice("co2_ppm", 180.0,
                                                  base=600.0, amplitude=80.0,
                                                  noise=5.0, seed=7)),
        SourceSpec("battery", "amqp", SimulatedDevice(
            "soc", 300.0, base=50.0, amplitude=20.0, seed=8)),
    ]
    cfg = PipelineConfig(n_envs=E, n_streams=len(sources), n_ticks=N_TICKS,
                         tick_s=TICK_S, max_samples=MAX_SAMPLES,
                         gap_strategy="locf", feature_agg="mean",
                         use_kernel=True)
    pred = Predictor(PolicyConfig("rglru", {"hidden": HIDDEN,
                                            "use_kernel": True}),
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=2),
                     ActionSpace(np.array([-1.0, -1.0]),
                                 np.array([1.0, 1.0])),
                     E, cfg.n_features, replay_capacity=CAPACITY,
                     device=dev)
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev-charger", "amqp", [1])])
    system = PerceptaSystem([f"bldg-{i}" for i in range(E)], sources, cfg,
                            pred, forwarders=hub,
                            db=LogDB(db_dir, salt="opeva"), mode=mode,
                            manual_time=True, scan_k=K, device=dev)
    # QoS-0 receivers drop data older than their backlog horizon; one scan
    # batch spans K windows, so the horizon covers a whole batch and a
    # K-window drain loses nothing (fused and scan then see the same data)
    for r in system.receivers:
        r.max_backlog_s = 2 * K * system.window_s
    return system


def phase_scan(dev, tmp):
    from repro_torch.kernels.locf import ops as locf_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.window_agg import ops as wagg_ops

    system = make_system("scan", dev, str(Path(tmp) / "scan"))
    spent = {"pump": 0.0, "assemble": 0.0, "device": 0.0, "decide": 0.0}

    def timed(name, fn, sync=False):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    system.pump_receivers = timed("pump", system.pump_receivers)
    system.assemble_windows = timed("assemble", system.assemble_windows)
    system._dispatch_scan = timed("device", system._dispatch_scan, True)
    system.predictor.on_windows = timed("decide",
                                        system.predictor.on_windows, True)
    locf_ops.LAUNCHES = wagg_ops.LAUNCHES = rglru_ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = system.run_windows(K * BATCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"locf": locf_ops.LAUNCHES, "window_agg": wagg_ops.LAUNCHES,
                "rglru_scan": rglru_ops.LAUNCHES}
    n = K * BATCHES
    check(len(results) == n, f"scan: {len(results)} results, expected {n}")
    check(launches == {"locf": n, "window_agg": 2 * n, "rglru_scan": n},
          f"scan: kernel launches {launches}, expected locf {n}, "
          f"window_agg {2 * n}, rglru_scan {n}")
    st = system.state
    for name, x in (("features", system.predictor._prev["obs"]),
                    ("actions", system.predictor._prev["actions"]),
                    ("norm mean", st.norm.mean), ("norm m2", st.norm.m2),
                    ("anomaly mean", st.anomaly.mean),
                    ("anomaly var", st.anomaly.var),
                    ("policy state", system.predictor._model_carry["h"])):
        check(bool(torch.isfinite(x).all()), f"scan: non-finite {name}")
    check(all(np.isfinite(r["mean_reward"]) for r in results),
          "scan: non-finite reward")
    exp = system.export_replay("salt")
    check(all(np.isfinite(exp[k]).all() for k in ("obs", "actions",
                                                   "rewards", "next_obs")),
          "scan: non-finite replay rows")
    check(system.replay_size() == n - 1,
          f"scan: replay size {system.replay_size()}, expected {n - 1}")
    check(sum(f.stats["sent"] for f in system.forwarders.forwarders)
          == 2 * E * n, "scan: forwarder count")
    records = sum(r["records"] for r in results)
    emit({"phase": "scan", "envs": E, "streams": system.cfg.n_streams,
          "windows": n, "windows_per_batch": K,
          "windows_per_s": n / wall, "records": records,
          "records_per_s": records / wall, "wall_s": wall,
          "pump_ms_per_batch": spent["pump"] * 1e3 / BATCHES,
          "host_assembly_ms_per_batch": spent["assemble"] * 1e3 / BATCHES,
          "device_ms_per_batch": spent["device"] * 1e3 / BATCHES,
          "decide_ms_per_batch": spent["decide"] * 1e3 / BATCHES,
          "launches": launches,
          "observed_frac": float(np.mean([r["observed_frac"]
                                          for r in results]))})
    profile_batch(system)
    system.db.close()
    system.stop()
    return launches


def profile_batch(system):
    """One more scan batch under the profiler: the card's busy time against
    the batch's wall time, and the kernels that took the most device time.
    Runs after the measured batches, so it touches none of their numbers."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.run_windows(K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = _device_us(dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "scan_profile", "windows": K, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_kernels": sum(e.count for e in dev),
          "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                            for e in top}})


def _db_rows(system):
    return [(r["env"], r["t"], r["action"], r["reward"])
            for _, r in system.db.read_from()]


def phase_fused(dev, tmp):
    n = K
    fused = make_system("fused", dev, str(Path(tmp) / "fused"))
    scan = make_system("scan", dev, str(Path(tmp) / "scan2"))
    # both systems' rglru weights come from the same builder seed
    for p, q in zip(fused.predictor.model.module.parameters(),
                    scan.predictor.model.module.parameters()):
        check(torch.equal(p, q), "fused/scan: policy weights differ")
    t0 = time.perf_counter()
    rf = fused.run_windows(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rs = scan.run_windows(n)
    # "records" counts what each drain brought: fused drains once per
    # window, scan once per batch and attributes records by timestamp, so
    # only the totals agree (as in the reference); every other key must
    # match exactly
    check(sum(r["records"] for r in rf) == sum(r["records"] for r in rs),
          "fused != scan: total records")
    for a, b in zip(rf, rs):
        a, b = dict(a), dict(b)
        for key in ("latency_s", "records"):
            a.pop(key)
            b.pop(key)
        check(a == b, f"fused != scan on window {a['window']}: {a} vs {b}")
    check(_db_rows(fused) == _db_rows(scan), "fused != scan in LogDB rows")
    ef, es = fused.export_replay("salt"), scan.export_replay("salt")
    check(ef["env_ids"] == es["env_ids"], "fused != scan: replay ids")
    for key in ef:
        if key != "env_ids":
            check(np.array_equal(ef[key], es[key]),
                  f"fused != scan: replay {key}")
    emit({"phase": "fused", "windows": n, "windows_per_s": n / wall,
          "bit_identical_to_scan": True})
    for s in (fused, scan):
        s.db.close()
        s.stop()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(cap), "count": torch.cuda.device_count()})
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")

    build_s = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "seconds": build_s,
          "library": str(_build.LIB_PATH.relative_to(REPO))})

    at_path = phase_kernels(dev)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        launches = phase_scan(dev, tmp)
        phase_fused(dev, tmp)

    emit({"kernels": [
        dict(name=name, route="cuda", parity="ok",
             source=KERNEL_META[name][0],
             replaces=KERNEL_META[name][1], launches=launches[name],
             **at_path[name]) for name in ("locf", "window_agg",
                                          "rglru_scan")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
