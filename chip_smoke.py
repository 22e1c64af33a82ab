"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
     versions; the card must be compute capability 9.0 (Hopper).
  2. build   — every CUDA kernel compiled from the repository's sources.
  3. kernels — each kernel against its plain PyTorch version on the card,
     at its path's shapes and at larger ones, with device times from the
     profiler (CUDA event pairs where the trace holds no device time).
     Kernels with instances (flash_attention; locf and window_agg:
     ``row`` at T <= 16, ``warp`` above; harmonize: ``warp``) name the
     instance each case ran, from the launch counts and the profiler's
     trace.
  4. scan    — the port's PerceptaSystem in ``scan`` mode at E=256 envs,
     S=8 sources, K=32 windows per batch, replay capacity 4096, the rglru
     policy: 4 batches (128 windows) timed, with every kernel launch
     counted (locf and window_agg all on their ``row`` instance), then one
     batch untimed with the bytes fetched to the host counted. Every batch
     mode is timed by the same host-clock instrument (``instrument``).
  5. fused   — the same system in ``fused`` mode for 32 windows, equal bit
     for bit to the first 32 windows of a fresh ``scan`` run.
  5a. fused_decide — the system in ``scan_fused_decide`` mode over the
     scan phase's windows (the decision step inside the pipeline's K loop,
     one ring write per batch): every window's result but ``latency_s``,
     the replay export, the forwarder sinks and the DB rows equal the scan
     phase's bit for bit; its launches counted as in phase 4; host bytes
     fetched per batch and one profiled batch beside the scan phase's.
  5b. async  — ``scan_async`` against the scan phase and
     ``scan_fused_decide_async`` against phase 5a, with the same checks;
     windows/s beside the synchronous twin's, and the pump time that
     overlapped the Manager's launch and consume.
  5c. loop_order — the four batch modes once more in reverse order
     (fresh systems, the same windows and checks), so each mode's
     windows/s is read early and late in the process.
  5c'. sharded — env sharding on logical shards of the card (the mesh
     names the card N times; all the cards too where there are more):
     (a) ``run_many`` and ``run_many_decide`` over the scan phase's last
     recorded batch on 1, 2, 4 and 8 shards, each bit for bit against the
     unsharded engine (features, frames, state, ``DecideBatch``, carry,
     ring), with the launches of one batch per kernel and instance (N*K
     locf, 2N*K window_agg, N*K rglru_scan, all ``row``), a profiled
     batch's device ms and activities and the host ms to launch it; (b)
     ``scan_fused_decide_sharded`` and ``scan_sharded`` for 2 batches on
     4 shards at E = 256, their async twins for 1, each against the
     first batches of its unsharded twin's run (results, sinks, LogDB
     rows, replay export); (c) an elastic pool in
     ``scan_fused_decide_sharded``, 4 slots on 4 shards grown to 8 on 8,
     its 4 stable envs bit for bit against a dense system.
  5c''. autotune — ``PerceptaSystem(scan_k="auto")`` in ``scan`` and
     ``scan_fused_decide`` with k_grid (8, 16, 32) and the default
     measure: the grid (windows/s of the engine alone), the chosen K (the
     grid's argmax) and the calibration seconds.
  5d. online_train — ``scan_fused_decide`` at the same config with the
     ``mlp`` policy (hidden 32) and ``train="online"`` (128 rows a step,
     a checkpoint every applied step), 4 batches a run, fresh systems
     without and with training in the order off, on, on, off (the two
     runs of each kind bit-equal; windows/s and their means). Checks:
     (a) a step on a fresh ring is an exact no-op at version 0; (b) two
     steps from the same inputs and indices are bit-equal; (c) a card
     step against the same step on the CPU within ``STEP_REL``; (d) batch
     0 with training equals batch 0 without; (e) LogDB rows carry their
     batch's version and replay rows the version behind their action;
     (f) ``restore_training`` puts the checkpointed bits and version into
     the carry. Also the step's profiler device ms and activities, its
     host launch ms, its host reads (none) and ``apply_pending``'s (one),
     and the mlp and rwkv6 policies' decides on the card against the CPU.
  5e. elastic — slot pools at the loop config in ``scan_fused_decide``
     (``phase_elastic``): a dense system over 160 envs for 5 batches; the
     same envs in a 256-slot pool, bit for bit against it in that mode
     and in ``scan`` (2 batches each); then churn in a 256-slot pool
     (detach 32, attach 96 into the recycled and free slots, attach one
     more, which grows the pool to 512), the stable envs' replay rows bit
     for bit against the dense run and the recycled slots free of their
     former tenants. Launches a batch, host ms of attach, detach and
     resize, windows/s beside the dense run's, the pool's device bytes at
     256 and 512 slots, and one profiled batch of the 256-slot pool beside
     the fused_decide phase's (a dense system of the same width).
  5f. modular — ``mode="modular"`` (each stage its own call, the host
     waiting after each) over phase 5's 32 windows, bit for bit against
     ``fused``; windows/s beside it; its launches.
  6. harmonize_system (run right after phase 4) — the harmonize op entry
     point on the K windows of one batch the scan system assembled, held against its plain version
     and against ``core.harmonize.harmonize_segment(agg="mean")``, and bit
     for bit against a sequential float32 loop; its instance (``warp``)
     from ``LAUNCHES_BY_IMPL`` and the profiler's trace, and the batch's
     device time.
  7. lm      — the LM side-car's serving path at qwen3-0.6b's full width
     (28 layers, d_model 1024, vocab 151936, bfloat16, seeded random
     weights): ``LM.prefill`` on 4 x 2048 tokens with one flash-attention
     launch per layer counted, decode against prefill, and a
     ``ServeEngine`` run at ``launch/serve.py``'s defaults.
  8. lm_family_<arch> — every other family of the registry at its
     published widths with seeded bfloat16 weights (``FAMILIES``):
     recurrentgemma-2b (RG-LRU + local attention), rwkv6-1.6b (RWKV-6,
     the chunked wkv timed beside the sequential one),
     moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b (MoE; phi3.5 cut in
     depth to what fits on the card, listed in its line), musicgen-medium
     (``frames`` in) and internvl2-26b (256 patches before the tokens).
     Each: prefill 4 x 2048 positions with its rglru_scan and
     flash_attention launches counted against its layers, two prefills bit
     for bit (MoE: the dropped share), decode against prefill reported
     (MoE at batch 1 and a capacity that cannot drop), a ``ServeEngine``
     drain for token input, profiled prefill and decode steps whose traces
     must name the kernels counted; then a float32 twin (depth fitted to
     the card) whose decode-vs-prefill and, for RWKV-6, chunked-vs-
     sequential relations are checked. Phase 3 also holds rglru_scan and
     flash_attention at recurrentgemma-2b's prefill shapes.
The line before the last holds one JSON object with every kernel's
numbers (``launches`` summed over the paths, ``launches_by_path`` each
path's, ``at_lm_shape`` the times at the LM prefill shape); the last line
is ``{"ok": true, "device": {...}}``. Without a
card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
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
BF16_OPS_PER_S = 989e12         # H100 SXM bfloat16 tensor cores, dense
E, K, BATCHES, CAPACITY = 256, 32, 4, 4096
N_TICKS, TICK_S, MAX_SAMPLES, HIDDEN = 8, 60.0, 32, 16
# the LM side-car: prefill batch and prompt length, the decode-vs-prefill
# tail, and launch/serve.py's defaults
LM_ARCH, LM_B, LM_S, LM_TAIL = "qwen3-0.6b", 4, 2048, 8
SERVE = dict(slots=4, max_seq=128, requests=8, prompt_len=8, new_tokens=16)
# the kernel cases at the LM families' prefill shapes (phase 3), by kernel
LM_SHAPE = {"rglru_scan": "lm_recurrentgemma",
            "flash_attention": "lm_recurrentgemma"}
# decode against prefill in bfloat16 over 28 layers: the two sides round
# at other places (the flash kernel keeps p in float32, decode rounds it to
# bfloat16; the products differ in shape and order), and the logits
# themselves are rounded to bfloat16 (an ulp is 2^-5 at |logit| in [4, 8)).
# Bound: 0.25, eight such ulps; see PERF.md
LM_DECODE_BOUND = 0.25


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also gets the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


class count_fetches:
    """Counts the bytes read from the card to the host while open: every
    ``Tensor.cpu()`` of a CUDA tensor and every Python scalar read of one
    (``int``, ``float``, ``bool``, ``.item()``). Patches ``torch.Tensor``
    for the duration; restores it on exit."""
    METHODS = ("cpu", "item", "__int__", "__float__", "__bool__")

    def __enter__(self):
        self.bytes = 0
        self.calls = 0
        self._saved = {m: getattr(torch.Tensor, m) for m in self.METHODS}

        def wrap(orig, scalar):
            def run(t, *args, **kwargs):
                if t.is_cuda:
                    self.calls += 1
                    self.bytes += t.element_size() * (1 if scalar
                                                      else t.numel())
                return orig(t, *args, **kwargs)
            return run

        for m, orig in self._saved.items():
            setattr(torch.Tensor, m, wrap(orig, m != "cpu"))
        return self

    def __exit__(self, *exc):
        for m, orig in self._saved.items():
            setattr(torch.Tensor, m, orig)
        return False


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


def _missing(events, want):
    """The names in ``want`` that no device kernel among ``events``
    contains."""
    from torch.autograd import DeviceType
    keys = [e.key for e in events if e.device_type == DeviceType.CUDA]
    return [w for w in want if not any(w in k for k in keys)]


def device_ms(fn, reps=20, warmup=3, tries=3, want=()):
    """Device time of one call: the card's busy time (every kernel the call
    launched, gaps between them excluded), from the profiler's CUPTI trace,
    averaged over ``reps`` calls. A trace now and then holds no device
    activity at all, or loses the kernels launched through the ctypes
    library (PERF.md §7); then it is taken again, up to ``tries`` times.
    If every trace came back empty, None is returned (the caller then
    reports event times); if every one lacks a kernel named in ``want``,
    the check fails rather than read low."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    missing = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = _device_us(events)
        missing = _missing(events, want)
        if total > 0 and not missing:
            return total / reps / 1e3
    check(not missing, f"device_ms: every trace lacks kernels {missing}")
    return None


def traced_kernels(fn, want, reps=10, tries=6):
    """Names of the device kernels containing ``want`` that ``reps`` calls
    of ``fn`` ran, from the profiler's trace (not from the wrappers'
    counters). A trace of a single call came back empty on the card, and
    after the sharded phase's large traces a trace holding only kernels
    launched through the ctypes library often lost them, while one that
    also held a PyTorch kernel kept them: each trace also runs one
    ``fill_`` on the card, and a trace without ``want`` is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros((), device="cuda")
    names = []
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            marker.fill_(1.0)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and want in e.key})
        if names:
            break
    return names


def bound(bytes_moved, ops, ops_rate=FP32_OPS_PER_S):
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate of their type (float32 outside
    the tensor cores by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- kernels
def check_instance(ops, name, label, call, impl, info, want=None):
    """Run ``call`` once: it must launch instance ``impl`` of kernel
    ``name`` (one more in ``ops.LAUNCHES_BY_IMPL``, nothing else), and a
    profiler trace of it must show one device kernel of that name, the
    instance's (``want``, by default ``<name>_<impl>_kernel``). Records
    both in ``info``; returns the output."""
    by_impl = dict(ops.LAUNCHES_BY_IMPL)
    out = call()
    by_impl[impl] += 1
    check(ops.LAUNCHES_BY_IMPL == by_impl,
          f"{name} {label}: launches by impl {ops.LAUNCHES_BY_IMPL}, "
          f"expected {by_impl}")
    want = want or f"{name}_{impl}_kernel"
    ran = traced_kernels(call, name)
    check(len(ran) == 1 and want in ran[0],
          f"{name} {label}: trace shows {ran}, expected {want}")
    info.update(impl=impl, traced_kernel=ran[0])
    return out


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
    # (4096 envs x 8 streams, 64 ticks); locf and window_agg run their row
    # instance on the first and their warp instance on the second
    for label, (e, s, t), impl in (("path", (E, 8, N_TICKS), "row"),
                                   ("fleet", (4096, 8, 64), "warp")):
        R = e * s
        v, o, iv, ih = rnd(e, s, t), mask(0.6, e, s, t), rnd(e, s), \
            mask(0.5, e, s)
        info = {}

        def locf_cmp(v=v, o=o, iv=iv, ih=ih, R=R, t=t, label=label,
                     impl=impl, info=info):
            out, has = check_instance(
                locf_ops, "locf", label,
                lambda: locf_ops.locf(v, o, iv, ih), impl, info)
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
            compare=locf_cmp, info=info,
            # read values + observed + carry, write filled + has
            bytes=R * t * 5 + R * 5 + R * t * 5, ops=0, library=None))

        w = 5.0 + 2.0 * rnd(e, s, t)
        m = mask(0.7, e, s, t)
        mu, var = 5.0 + rnd(e, s), 1.0 + rnd(e, s).abs()
        info = {}

        def wagg_cmp(w=w, m=m, mu=mu, var=var, R=R, t=t, label=label,
                     impl=impl, info=info):
            stats, spikes = check_instance(
                wagg_ops, "window_agg", label,
                lambda: wagg_ops.window_agg(w, m, mu, var, k_sigma=1.5),
                impl, info)
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
            compare=wagg_cmp, info=info,
            # read values + mask + (mean, var), write 8 stats + spikes;
            # ~11 float32 operations per element over the two passes
            bytes=R * t * 5 + R * 8 + R * 8 * 4 + R * t,
            ops=11 * R * t, library=None))

    # B x T x W: the path (B=E, T=1, W=hidden), a fleet step (4096 envs),
    # a long sequence (64 x 1024 x 256) and recurrentgemma-2b's prefill
    # (4 x 2048 x 2560: the RG-LRU block's scan over the sequence)
    for label, (b_, t, w_) in (("path", (E, 1, HIDDEN)),
                               ("fleet", (4096, 1, HIDDEN)),
                               ("sequence", (64, 1024, 256)),
                               (LM_SHAPE["rglru_scan"],
                                (LM_B, LM_S, 2560))):
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
    return cases + harmonize_cases(dev, g) + flash_cases(dev, g)


def sequential_harmonize(v, ts, ok, t0, tick_s, T):
    """(R, M) rows -> (means, observed) as a sequential float32 loop over
    the samples, one torch op at a time (nothing fused into an FMA):
    ``total = total + h * v``, ``count = count + h``. The harmonize kernel
    adds in this order, so its means equal these bit for bit."""
    from repro_torch.core.harmonize import exact_div
    R, M = v.shape
    idx = torch.ceil(exact_div(ts - t0[:, None], tick_s)).to(torch.int32) - 1
    hit = ok & (idx >= 0) & (idx < T)
    ticks = torch.arange(T, dtype=torch.int32, device=v.device)
    total = torch.zeros((R, T), device=v.device)
    count = torch.zeros((R, T), device=v.device)
    for m in range(M):
        h = ((idx[:, m, None] == ticks) & hit[:, m, None]).to(torch.float32)
        total = total + h * v[:, m, None]
        count = count + h
    observed = count > 0
    return torch.where(observed, total / count.clamp(min=1.0), 0.0), observed


def bits_equal(a, b):
    """Equal bit for bit, NaN positions included."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


def harmonize_cases(dev, g):
    """The decision loop's window (E=256, S=8, M=32, T=8) and a fleet
    window (4096 envs x 8 streams, 64 ticks, 128 samples). Each runs the
    kernel's ``warp`` instance with staged float4 loads (``impl_for``),
    checked through ``LAUNCHES_BY_IMPL`` and the profiler's kernel name;
    its means must equal a sequential float32 loop bit for bit."""
    from repro_torch.kernels.harmonize import ops as hz_ops
    from repro_torch.kernels.harmonize.ref import harmonize_ref

    cases = []
    for label, (e, s, m, t) in (("path", (E, 8, MAX_SAMPLES, N_TICKS)),
                                ("fleet", (4096, 8, 128, 64))):
        R = e * s
        # timestamps from half a tick before the window to one after it
        ts = (torch.rand((e, s, m), generator=g, device=dev) * (t + 1.5)
              - 0.5) * TICK_S
        v = torch.randn((e, s, m), generator=g, device=dev)
        ok = torch.rand((e, s, m), generator=g, device=dev) < 0.8
        ws = (torch.rand((e,), generator=g, device=dev) - 0.5) * TICK_S

        def plain(v=v, ts=ts, ok=ok, ws=ws, R=R, m=m, t=t, s=s):
            return harmonize_ref(v.reshape(R, m), ts.reshape(R, m),
                                 ok.reshape(R, m), ws.repeat_interleave(s),
                                 TICK_S, t)

        def kernel(v=v, ts=ts, ok=ok, ws=ws, t=t):
            return hz_ops.harmonize(v, ts, ok, ws, tick_s=TICK_S, n_ticks=t)

        info = {}

        def cmp(kernel=kernel, plain=plain, R=R, m=m, t=t, label=label,
                info=info, args=(v, ts, ok, ws, s)):
            from repro_torch.kernels.rows import aligned
            impl, vec = hz_ops.impl_for(m, aligned(*args[:3]))
            check((impl, vec) == ("warp", True),
                  f"harmonize {label}: impl_for gives {(impl, vec)}")
            out, obs = check_instance(hz_ops, "harmonize", label, kernel,
                                      impl, info)
            ref, ref_obs = plain()
            out, obs = out.reshape(R, t), obs.reshape(R, t)
            check(torch.equal(obs, ref_obs), "harmonize: observed differs")
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
            v, ts, ok, ws, s = args
            seq, _ = sequential_harmonize(v.reshape(R, m), ts.reshape(R, m),
                                          ok.reshape(R, m),
                                          ws.repeat_interleave(s), TICK_S, t)
            check(bits_equal(out, seq),
                  f"harmonize {label}: differs from the sequential loop")
            info.update(vec=vec, bit_equal_sequential=True)
            return (out - ref).abs().max().item()

        cases.append(dict(
            name="harmonize", shape=label, dims=dict(R=R, M=m, T=t),
            kernel=kernel, plain=plain, compare=cmp, info=info,
            # read values, timestamps, valid and t0, write means + observed;
            # per sample a subtract, divide and ceil for the bucket and two
            # adds into it, per tick one divide
            bytes=R * m * 9 + e * 4 + R * t * 5, ops=5 * R * m + R * t,
            library=None))
    return cases


# the source file of each flash-attention kernel, and the name its device
# kernel carries in a profiler trace
# the part of a port kernel's device name a trace must show ("rglru"
# covers its scan and step instances)
TRACE_NAME = {"locf": "locf", "window_agg": "window_agg",
              "rglru_scan": "rglru", "harmonize": "harmonize",
              "flash_attention": "flash_attention"}
# the loop's kernels in a traced batch
LOOP_TRACE = ("locf", "window_agg", "rglru")

FA_KERNELS = {
    "wgmma": ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_sm90.cu", "flash_attention_sm90_kernel"),
    "scalar": ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu", "flash_attention_kernel"),
}


def flash_cases(dev, g):
    """qwen3-0.6b's prefill attention (B=4, 16 q / 8 kv heads, head dim
    128, S=2048) in bfloat16 and float32, a ragged S, a window and a
    softcap; gemma2-2b's (8 q / 4 kv heads, head dim 256, its 4096
    window and attention cap of 50); and recurrentgemma-2b's (10 q heads
    over 1 kv head, head dim 256, window 2048). Each case names the
    kernel it must run (``ops.impl_for``), checked through
    ``LAUNCHES_BY_IMPL`` and the kernel names in a profiler trace. Tolerances: float32 max abs err
    2e-3 (tests/test_kernels.py); bfloat16 one ulp of the plain output, |out - ref| <= 2^-7 |ref| + 1e-5
    per element, since both compute in float32 and round the output once
    (late rows attend to ~2048 keys and their outputs are ~0.04, so an
    absolute bound would have to be far smaller than 5e-2 to see a dropped
    tile). The softcap case scales q by 8 so that scores reach tens and the
    cap of 50 (gemma2's) changes the output; the script checks that it
    does."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B = LM_B
    cases = []
    for label, dtype, S, window, softcap, (H, HKV, D), impl in (
            ("path", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 128), "wgmma"),
            ("path_f32", torch.float32, LM_S, 0, 0.0, (16, 8, 128),
             "scalar"),
            ("ragged", torch.bfloat16, 1000, 0, 0.0, (16, 8, 128), "wgmma"),
            ("window", torch.bfloat16, LM_S, 512, 0.0, (16, 8, 128),
             "wgmma"),
            ("softcap", torch.bfloat16, LM_S, 0, 50.0, (16, 8, 128),
             "wgmma"),
            ("gemma_d256", torch.bfloat16, LM_S, 4096, 50.0, (8, 4, 256),
             "wgmma"),
            # recurrentgemma-2b's local attention: at S = 2048 its 2048
            # window equals causal, so SDPA computes the same function
            (LM_SHAPE["flash_attention"], torch.bfloat16, LM_S, 2048, 0.0,
             (10, 1, 256), "wgmma")):
        check(fa_ops.impl_for(dtype, D) == impl,
              f"flash_attention {label}: impl_for gives "
              f"{fa_ops.impl_for(dtype, D)}, expected {impl}")
        q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev)
                   .to(dtype) for h in (H, HKV, HKV))
        if softcap:
            q = q * 8
        kw = dict(window=window, softcap=softcap)
        info = {}

        def cmp(q=q, k=k, v=v, kw=kw, dtype=dtype, label=label, info=info,
                impl=impl):
            out = check_instance(
                fa_ops, "flash_attention", label,
                lambda: fa_ops.flash_attention(q, k, v, **kw), impl, info,
                want=FA_KERNELS[impl][1])
            ref = attention_ref(q, k, v, **kw).float()
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            check(out.dtype == q.dtype, f"flash_attention {label}: dtype")
            if dtype == torch.bfloat16:
                ratio = (diff / (2.0 ** -7 * ref.abs() + 1e-5)).max().item()
                info.update(tol="2^-7 |ref| + 1e-5", err_over_tol=ratio,
                            ref_mean_abs=ref.abs().mean().item())
                check(ratio <= 1.0, f"flash_attention {label}: error "
                      f"{ratio} x the one-ulp bound (max abs {err})")
            else:
                info.update(tol=2e-3, err_over_tol=err / 2e-3)
                check(err <= 2e-3, f"flash_attention {label}: max abs err "
                      f"{err} > 2e-3")
            if kw["softcap"]:
                uncapped = attention_ref(q, k, v, window=kw["window"])
                effect = (uncapped.float() - ref).abs().max().item()
                info["softcap_effect"] = effect
                check(effect > 0.1, f"flash_attention {label}: the softcap "
                      f"moves the output by only {effect}")
            return err

        lib = None
        if window in (0, S) and not softcap:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        w = window or S
        pairs = sum(min(i + 1, w) for i in range(S))   # (q, k) pairs scored
        cases.append(dict(
            name="flash_attention", shape=label,
            dims=dict(B=B, S=S, H=H, Hkv=HKV, D=D, dtype=str(dtype)[6:],
                      window=window, softcap=softcap),
            kernel=lambda q=q, k=k, v=v, kw=kw: fa_ops.flash_attention(
                q, k, v, **kw),
            plain=lambda q=q, k=k, v=v, kw=kw: attention_ref(q, k, v, **kw),
            compare=cmp, info=info,
            # read q, k, v, write out; QK^T and PV, 2 flops per MAC each
            bytes=2 * B * S * (H + HKV) * D * q.element_size(),
            ops=4 * B * H * D * pairs,
            ops_rate=(BF16_OPS_PER_S if dtype == torch.bfloat16
                      else FP32_OPS_PER_S),
            library=lib))
    return cases


KERNEL_META = {
    "locf": ("src/repro_torch/kernels/locf/csrc/locf.cu",
             "src/repro/kernels/locf/kernel.py:36"),
    "window_agg": ("src/repro_torch/kernels/window_agg/csrc/window_agg.cu",
                   "src/repro/kernels/window_agg/kernel.py:59"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:35"),
    "harmonize": ("src/repro_torch/kernels/harmonize/csrc/harmonize.cu",
                  "src/repro/kernels/harmonize/kernel.py:47"),
    "flash_attention": (FA_KERNELS["wgmma"][0],
                        "src/repro/kernels/flash_attention/kernel.py:71"),
}


def phase_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    at_path, at_lm = {}, {}
    for case in kernel_cases(dev, g):
        err = case["compare"]()
        long_ = case["shape"] in ("sequence", LM_SHAPE["rglru_scan"]) or \
            case["name"] == "flash_attention"
        reps = 20 if long_ else 50
        calls = {k: call_ms(case[k], reps=reps) for k in
                 ("kernel", "plain", "library") if case[k] is not None}
        dev_ms = {k: device_ms(case[k], want=(TRACE_NAME[case["name"]],)
                               if k == "kernel" else ()) for k in calls}
        timer = "profiler" if all(v is not None
                                  for v in dev_ms.values()) else "events"
        t = dev_ms if timer == "profiler" else calls
        ms, plain_ms, lib_ms = t["kernel"], t["plain"], t.get("library")
        bound_ms, bound_by = bound(case["bytes"], case["ops"],
                                   case.get("ops_rate", FP32_OPS_PER_S))
        us = lambda x: None if x is None else x * 1e3
        emit(dict(kernel=case["name"], shape=case["shape"], **case["dims"],
                  parity="ok", max_abs_err=err, **case.get("info", {}),
                  timer=timer, us=us(ms),
                  plain_us=us(plain_ms), library_us=us(lib_ms),
                  bound_us=us(bound_ms), bound_by=bound_by,
                  call_us=us(calls["kernel"]),
                  plain_call_us=us(calls["plain"]),
                  library_call_us=us(calls.get("library"))))
        if case["shape"] == "path":
            impl = case.get("info", {}).get("impl")
            at_path[case["name"]] = dict(
                **({"impl": impl} if impl else {}), max_abs_err=err,
                timer=timer, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)
        if case["shape"] == LM_SHAPE.get(case["name"]):
            at_lm[case["name"]] = dict(
                shape=case["shape"], **case["dims"], max_abs_err=err,
                us=us(ms), plain_us=us(plain_ms), bound_us=us(bound_ms),
                bound_by=bound_by, library_us=us(lib_ms))
    return at_path, at_lm


# --------------------------------------------------------------- system
def make_system(mode, dev, db_dir, policy=None, env_ids=None, slots=None,
                **system_kw):
    """The decision loop's system (§4's loop config) over ``env_ids`` (the
    E buildings ``bldg-0..`` by default) in a pool of ``slots`` rows
    (``len(env_ids)`` by default; more needs ``elastic=True``)."""
    from repro_torch.runtime.db import LogDB
    from repro_torch.runtime.forwarder import Forwarder, ForwarderHub
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
    env_ids = env_ids or [f"bldg-{i}" for i in range(E)]
    n = slots or len(env_ids)
    cfg = loop_config(n)
    pred = loop_predictor(cfg, dev, policy)
    hub = ForwarderHub([Forwarder("hvac", "mqtt", [0]),
                        Forwarder("ev-charger", "amqp", [1])])
    system_kw.setdefault("scan_k", K)
    system = PerceptaSystem(env_ids, sources, cfg, pred, forwarders=hub,
                            db=LogDB(db_dir, salt="opeva"), mode=mode,
                            manual_time=True, device=dev,
                            env_slots=slots, **system_kw)
    # QoS-0 receivers drop data older than their backlog horizon; one scan
    # batch spans K windows, so the horizon covers a whole batch and a
    # K-window drain loses nothing (fused and scan then see the same data)
    for r in system.receivers:
        r.max_backlog_s = 2 * K * system.window_s
    return system


def loop_config(n):
    """§4's loop config at ``n`` env rows (8 sources)."""
    from repro_torch.core import PipelineConfig
    return PipelineConfig(n_envs=n, n_streams=8, n_ticks=N_TICKS,
                          tick_s=TICK_S, max_samples=MAX_SAMPLES,
                          gap_strategy="locf", feature_agg="mean",
                          use_kernel=True)


def loop_predictor(cfg, dev, policy=None):
    """The loop's Predictor: the rglru policy (hidden 16, its kernel on)
    unless ``policy`` says otherwise, replay capacity 4096."""
    from repro_torch.core.reward import energy_reward_spec
    from repro_torch.runtime.policies import PolicyConfig
    from repro_torch.runtime.predictor import ActionSpace, Predictor
    policy = policy or PolicyConfig("rglru", {"hidden": HIDDEN,
                                              "use_kernel": True})
    return Predictor(policy,
                     energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=2),
                     ActionSpace(np.array([-1.0, -1.0]),
                                 np.array([1.0, 1.0])),
                     cfg.n_envs, cfg.n_features, replay_capacity=CAPACITY,
                     device=dev)


# the decision loop's batch modes, and the twin each must equal bit for bit
LOOP_TWIN = {"scan": "scan", "scan_fused_decide": "scan",
             "scan_async": "scan",
             "scan_fused_decide_async": "scan_fused_decide"}


def instrument(system):
    """Host-clock intervals of the loop's parts, taken the same way in every
    mode: the receivers' poll (``pump``), the drain and close into staging
    (``assemble``; in the async modes both run on the pump thread) and the
    Manager's launch + consume with the sinks (``manager``: the consume's
    first fetch waits for the batch, so it covers the batch's device
    work). Returns the dict of interval lists that ``drive_loop`` reads."""
    spans = {"pump": [], "assemble": [], "manager": []}
    system.pump_receivers = interval(system.pump_receivers, spans["pump"])
    system.assemble_windows = interval(system.assemble_windows,
                                       spans["assemble"])
    system._dispatch_batch = interval(system._dispatch_batch,
                                      spans["manager"])
    system._consume_batch = interval(system._consume_batch, spans["manager"])
    return spans


def interval(fn, into, sync=False):
    """``fn`` that appends its (start, end) on the host clock to ``into``;
    with ``sync``, the end waits for the card."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            into.append((t0, time.perf_counter()))
    return run


def _overlap_s(a, b):
    """Total time in which an interval of ``a`` and one of ``b`` overlap."""
    return sum(max(0.0, min(x1, y1) - max(x0, y0))
               for x0, x1 in a for y0, y1 in b)


def _zero_launches():
    from repro_torch.kernels.locf import ops as locf_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.window_agg import ops as wagg_ops
    locf_ops.LAUNCHES = wagg_ops.LAUNCHES = rglru_ops.LAUNCHES = 0
    for ops in (locf_ops, wagg_ops):
        ops.LAUNCHES_BY_IMPL.update(row=0, warp=0)


def _read_launches():
    """The three loop kernels' launches since ``_zero_launches``, and
    locf's and window_agg's by instance."""
    from repro_torch.kernels.locf import ops as locf_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.window_agg import ops as wagg_ops
    return ({"locf": locf_ops.LAUNCHES, "window_agg": wagg_ops.LAUNCHES,
             "rglru_scan": rglru_ops.LAUNCHES},
            {"locf": dict(locf_ops.LAUNCHES_BY_IMPL),
             "window_agg": dict(wagg_ops.LAUNCHES_BY_IMPL)})


def check_loop_launches(label, launches, by_impl, n, rglru=None):
    """n windows of the loop: locf n, window_agg 2n, rglru_scan n (or
    ``rglru``: 0 for a policy without the kernel), every locf and
    window_agg launch on the ``row`` instance (T = 8)."""
    rglru = n if rglru is None else rglru
    check(launches == {"locf": n, "window_agg": 2 * n, "rglru_scan": rglru},
          f"{label}: kernel launches {launches}, expected locf {n}, "
          f"window_agg {2 * n}, rglru_scan {rglru}")
    check(by_impl == {"locf": {"row": n, "warp": 0},
                      "window_agg": {"row": 2 * n, "warp": 0}},
          f"{label}: launches by instance {by_impl}, expected all row")


def _strip(results):
    return [{k: v for k, v in r.items() if k != "latency_s"}
            for r in results]


def drive_loop(system, label, spans, batches=None, count_bytes=True):
    """The decision loop's main path: ``K * batches`` windows through
    ``system.run_windows``, timed, with every kernel count set to 0 just
    before and read just after. Checks locf n, window_agg 2n and rglru_scan
    n launches, all locf and window_agg launches on the ``row`` instance.
    Then (``count_bytes``) one more batch, untimed, under ``count_fetches``
    for the bytes fetched to the host (the patched ``Tensor`` methods stay
    out of the timed run). Returns the run's reading: every window's
    result (timed and counted batches), windows/s, launches, and per batch
    the ms of each interval list in ``spans`` (timed batches only), the
    pump and assembly time that overlapped the Manager's, and the host
    bytes."""
    batches = BATCHES if batches is None else batches
    n = K * batches
    _zero_launches()
    for v in spans.values():
        v.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = system.run_windows(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_impl = _read_launches()
    ms = {f"{k}_ms_per_batch": sum(b - a for a, b in v) * 1e3 / batches
          for k, v in spans.items()}
    ms["pump_overlapping_manager_ms_per_batch"] = _overlap_s(
        spans["pump"] + spans["assemble"], spans["manager"]) * 1e3 / batches
    check(len(results) == n,
          f"{label}: {len(results)} results, expected {n}")
    check_loop_launches(label, launches, by_impl, n)
    out = {"results": results, "windows_per_s": n / wall, "wall_s": wall,
           "launches": launches, "launches_by_impl": by_impl, **ms}
    if count_bytes:
        with count_fetches() as fetched:
            out["results"] = results + system.run_windows(K)
            torch.cuda.synchronize()
        out["host_bytes_per_batch"] = fetched.bytes
    return out


def loop_record(system, run):
    """What a run of the decision loop left behind, for the bit-for-bit
    comparison of two modes over the same windows."""
    return {"results": _strip(run["results"]),
            "export": system.export_replay("salt"),
            "db_rows": _db_rows(system),
            "sinks": [list(f.sink) for f in system.forwarders.forwarders],
            **{k: v for k, v in run.items() if k != "results"}}


def run_mode(mode, dev, tmp, tag="", **drive):
    """A fresh ``mode`` system driven by ``drive_loop`` (``drive``: its
    batches and byte count) with the same instrument as every other mode;
    returns it and its record."""
    system = make_system(mode, dev, str(Path(tmp) / f"{mode}{tag}"))
    spans = instrument(system)
    run = drive_loop(system, mode + tag, spans, **drive)
    return system, loop_record(system, run)


def timing(rec):
    """The timing keys of a loop record, for a phase's line."""
    return {k: v for k, v in rec.items()
            if k.endswith("_per_batch") or k in ("windows_per_s", "wall_s")}


def phase_scan(dev, tmp):
    system = make_system("scan", dev, str(Path(tmp) / "scan"))
    spans = instrument(system)
    spans["device"], spans["decide"] = [], []
    captured = {}

    def keep_batch(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            captured["raw"] = out[0]
            return out
        return run

    system.assemble_windows = keep_batch(system.assemble_windows)
    # the pipeline's and the decision step's share, each up to the card's
    # completion (scan only: the fused path has no seam between them)
    system._dispatch_scan = interval(system._dispatch_scan, spans["device"],
                                     sync=True)
    system.predictor.on_windows = interval(system.predictor.on_windows,
                                           spans["decide"], sync=True)
    run = drive_loop(system, "scan", spans)
    n = K * BATCHES + K
    st = system.state
    for name, x in (("features", system.predictor._prev["obs"]),
                    ("actions", system.predictor._prev["actions"]),
                    ("norm mean", st.norm.mean), ("norm m2", st.norm.m2),
                    ("anomaly mean", st.anomaly.mean),
                    ("anomaly var", st.anomaly.var),
                    ("policy state", system.predictor._model_carry["h"])):
        check(bool(torch.isfinite(x).all()), f"scan: non-finite {name}")
    check(all(np.isfinite(r["mean_reward"]) for r in run["results"]),
          "scan: non-finite reward")
    ref = loop_record(system, run)
    exp = ref["export"]
    check(all(np.isfinite(exp[k]).all() for k in ("obs", "actions",
                                                   "rewards", "next_obs")),
          "scan: non-finite replay rows")
    check(system.replay_size() == n - 1,
          f"scan: replay size {system.replay_size()}, expected {n - 1}")
    check(sum(f.stats["sent"] for f in system.forwarders.forwarders)
          == 2 * E * n, "scan: forwarder count")
    timed = run["results"][:K * BATCHES]
    records = sum(r["records"] for r in timed)
    emit({"phase": "scan", "envs": E, "streams": system.cfg.n_streams,
          "windows": K * BATCHES, "windows_per_batch": K,
          "records": records, "records_per_s": records / run["wall_s"],
          **timing(ref), "launches": run["launches"],
          "launches_by_impl": run["launches_by_impl"],
          "observed_frac": float(np.mean([r["observed_frac"]
                                          for r in timed]))})
    ref["profile"] = profile_batch(system, "scan_profile")
    system.db.close()
    system.stop()
    return run["launches"], captured["raw"], ref


def check_same_loop(label, got, ref):
    """Every result but ``latency_s``, the replay export in every field,
    the forwarder sinks and the DB rows must be equal bit for bit."""
    check(len(got["results"]) == len(ref["results"]),
          f"{label}: {len(got['results'])} results, expected "
          f"{len(ref['results'])}")
    for a, b in zip(got["results"], ref["results"]):
        check(a == b, f"{label} on window {a['window']}: {a} vs {b}")
    ea, eb = got["export"], ref["export"]
    check(ea["env_ids"] == eb["env_ids"], f"{label}: replay ids")
    for key in eb:
        if key != "env_ids":
            check(ea[key].dtype == eb[key].dtype
                  and np.array_equal(ea[key], eb[key]),
                  f"{label}: replay {key} differs")
    check(got["sinks"] == ref["sinks"], f"{label}: forwarder sinks differ")
    check(got["db_rows"] == ref["db_rows"], f"{label}: LogDB rows differ")


def profile_batch(system, phase="scan_profile"):
    """One more batch under the profiler: the card's busy time against the
    batch's wall time, and the kernels that took the most device time.
    Runs after the measured batches, so it touches none of their numbers.
    The trace must show the loop's kernels (``LOOP_TRACE``), or the check
    fails rather than read low. Emits and returns the reading."""
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
    missing = _missing(dev, LOOP_TRACE)
    check(not missing, f"{phase}: the trace lacks kernels {missing}")
    busy_ms = _device_us(dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out = {"phase": phase, "windows": K, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_kernels": sum(e.count for e in dev),
           "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                             for e in top}}
    emit(out)
    return out


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
    run = {"results": rf, "windows_per_s": n / wall, "export": ef,
           "db_rows": _db_rows(fused)}
    for s in (fused, scan):
        s.db.close()
        s.stop()
    return run


def phase_fused_decide(dev, tmp, ref):
    """``scan_fused_decide`` over the scan phase's windows, equal to it bit
    for bit; its own launches, host bytes and one profiled batch."""
    system, got = run_mode("scan_fused_decide", dev, tmp)
    check_same_loop("fused_decide != scan", got, ref)
    n = K * BATCHES + K
    check(system.replay_size() == n - 1,
          f"fused_decide: replay size {system.replay_size()}")
    snap = system.snapshot_decide()
    for name, x in (("prev obs", snap.prev_obs),
                    ("prev actions", snap.prev_actions),
                    ("policy state", snap.carry["h"])):
        check(bool(torch.isfinite(x).all()), f"fused_decide: non-finite "
              f"{name}")
    check(int(snap.tick) == n and bool(snap.have_prev),
          f"fused_decide: carried tick {int(snap.tick)}, expected {n}")
    emit({"phase": "fused_decide", "windows": K * BATCHES,
          "windows_per_batch": K, **timing(got),
          "scan_windows_per_s": ref["windows_per_s"],
          "scan_manager_ms_per_batch": ref["manager_ms_per_batch"],
          "scan_host_bytes_per_batch": ref["host_bytes_per_batch"],
          "launches": got["launches"],
          "launches_by_impl": got["launches_by_impl"],
          "bit_identical_to_scan": True})
    prof = got["profile"] = profile_batch(system, "fused_decide_profile")
    emit({"phase": "fused_decide_vs_scan_profile",
          "device_busy_ms": [prof["device_busy_ms"],
                             ref["profile"]["device_busy_ms"]],
          "device_idle_share": [prof["device_idle_share"],
                                ref["profile"]["device_idle_share"]],
          "device_kernels": [prof["device_kernels"],
                             ref["profile"]["device_kernels"]]})
    system.db.close()
    system.stop()
    return got["launches"], got


def phase_async(dev, tmp, refs):
    """``scan_async`` and ``scan_fused_decide_async`` over the same windows,
    each equal to its synchronous twin's run bit for bit; windows/s beside
    the twin's, and the pump and assembly time that overlapped the
    Manager's launch and consume (host-clock intervals of the two
    threads)."""
    for mode in ("scan_async", "scan_fused_decide_async"):
        twin = LOOP_TWIN[mode]
        system, got = run_mode(mode, dev, tmp)
        check_same_loop(f"{mode} != {twin}", got, refs[twin])
        refs[mode] = got
        emit({"phase": f"async_{mode}", "windows": K * BATCHES,
              **timing(got), "twin": twin,
              "twin_windows_per_s": refs[twin]["windows_per_s"],
              "launches": got["launches"],
              "launches_by_impl": got["launches_by_impl"],
              "bit_identical_to_twin": True})
        system.db.close()
        system.stop()


# loop_order's depth: timed batches a mode (the first runs time BATCHES)
LATE_BATCHES = 1


def phase_loop_order(dev, tmp, first):
    """The four batch modes again, fresh systems over the same windows, in
    the reverse of the order the phases above ran them, ``LATE_BATCHES``
    each, checked bit for bit against the first batches of its twin's
    first run. A mode's windows/s is then read once early and once late in
    the process (host time of identical work drifts within one run), and
    the mean of its two readings is what compares modes."""
    order = list(LOOP_TWIN)
    out = {"phase": "loop_order", "order": [order, order[::-1]],
           "late_batches": LATE_BATCHES}
    for mode in order[::-1]:
        system, got = run_mode(mode, dev, tmp, tag="_late",
                               batches=LATE_BATCHES, count_bytes=False)
        _prefix_equal(f"{mode} (late) != {LOOP_TWIN[mode]}", got,
                      first[LOOP_TWIN[mode]], K * LATE_BATCHES)
        system.db.close()
        system.stop()
        for key in ("windows_per_s", "pump_ms_per_batch",
                    "assemble_ms_per_batch", "manager_ms_per_batch"):
            pair = [first[mode][key], got[key]]
            out.setdefault(key, {})[mode] = pair + [sum(pair) / 2]
    emit(out)


# ---------------------------------------------------------- env sharding
# the sharded phase (PERF.md §4): logical shards of the one card (the
# counterpart of the reference's forced host-device count), and the real
# cards where there are more than one
SHARDS = (1, 2, 4, 8)
SYS_SHARDS = 4
EL_SHARDED = (4, 8)     # elastic pool: slots on as many shards, grown


class logical_shards:
    """``sharding.visible_devices`` lists ``n`` copies of the card while
    the block runs (the mesh then splits the rows into n shards)."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from repro_torch.distribution import sharding as sh
        self.saved = sh.visible_devices
        sh.visible_devices = lambda device: [torch.device(device)] * self.n

    def __exit__(self, *exc):
        from repro_torch.distribution import sharding as sh
        sh.visible_devices = self.saved


def _clone_tree(t):
    from repro_torch.train import tree
    return tree.map_(lambda x: x.clone(), t)


def engine_shards(dev, raw):
    """(a) ``run_many`` and ``run_many_decide`` over one recorded batch of
    the scan phase (``raw``, K windows at E = 256) on each mesh of
    ``SHARDS`` logical shards of the card (and of all the cards where
    there are more), each bit for bit against the unsharded engines from
    the same state and carry. Per mesh: the launches of one batch per
    kernel and instance (counts set to 0 just before and read just after
    each engine call), the device ms and activities of a profiled batch
    and the host ms to launch one."""
    from repro_torch.core import pipeline as pl
    from repro_torch.distribution import sharding as sh
    cfg = loop_config(E)
    pred = loop_predictor(cfg, dev)
    decide = pred.make_decide_fn()
    d0 = _clone_tree(pred.decide_state())
    starts = torch.zeros((K, E), device=dev)
    with torch.no_grad():
        ref_state, ref_feats, ref_frames = pl.run_many(
            cfg, pl.init_state(cfg, dev), raw, starts)
        ref_fstate, ref_d, ref_out = pl.run_many_decide(
            cfg, decide, pl.init_state(cfg, dev), _clone_tree(d0), raw,
            starts)
    meshes = [("logical", sh.env_mesh(E, [dev] * n)) for n in SHARDS]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", sh.env_mesh(E, sh.visible_devices(dev))))
    plain = {"state": pl.init_state(cfg, dev), "d": _clone_tree(d0)}

    def plain_run():
        with torch.no_grad():
            pl.run_many_decide(cfg, decide, plain["state"], plain["d"], raw,
                               starts)

    p_ms, p_acts = profile_step(plain_run, reps=1, want=LOOP_TRACE)
    out = {"unsharded": {"device_ms_per_batch": p_ms,
                         "device_activities_per_batch": p_acts,
                         "host_launch_ms_per_batch": host_launch_ms(
                             plain_run, reps=3)}}
    for kind, mesh in meshes:
        n = mesh.size
        label = f"sharded (a), {n} {kind} shards"
        scan = pl.PerceptaPipeline(cfg, "scan_sharded", device=dev,
                                   mesh=mesh)
        fused = pl.PerceptaPipeline(cfg, "scan_fused_decide_sharded",
                                    device=dev, decide=decide, mesh=mesh,
                                    decide_state=d0)
        st, fst = scan.init_state(), fused.init_state()
        dsh = fused.place_decide(_clone_tree(d0))
        torch.cuda.synchronize()
        _zero_launches()
        with torch.no_grad():
            st, feats, frames = scan.run_many(st, raw, starts)
        torch.cuda.synchronize()
        l_scan, bi_scan = _read_launches()
        check_loop_launches(label + " run_many", l_scan, bi_scan, n * K,
                            rglru=0)
        _zero_launches()
        with torch.no_grad():
            fst, dsh, bout = fused.run_many_decide(fst, dsh, raw, starts)
        torch.cuda.synchronize()
        l_fused, bi_fused = _read_launches()
        check_loop_launches(label + " run_many_decide", l_fused, bi_fused,
                            n * K)
        for name, got, want in (
                ("features", feats, ref_feats),
                ("frames", frames, ref_frames),
                ("state", scan.gather_state(st), ref_state),
                ("DecideBatch", bout, ref_out),
                ("fused state", fused.gather_state(fst), ref_fstate),
                ("decide carry and ring", fused.gather_decide(dsh), ref_d)):
            check(tree_bits_equal(got, want),
                  f"{label}: {name} differ from the unsharded engine's")
        check(sh.replicas_agree(dsh, sh.decide_specs(dsh[0], 0)),
              f"{label}: the shards' scalars differ")
        cell = {"state": fst, "d": dsh}

        def run():
            with torch.no_grad():
                fused.run_many_decide(cell["state"], cell["d"], raw, starts)

        ms, acts = profile_step(run, reps=1, want=LOOP_TRACE)
        out[f"{n}_{kind}"] = {
            "launches_per_batch": {"run_many": l_scan,
                                   "run_many_decide": l_fused},
            "launches_by_impl": {"run_many": bi_scan,
                                 "run_many_decide": bi_fused},
            "device_ms_per_batch": ms, "device_activities_per_batch": acts,
            "host_launch_ms_per_batch": host_launch_ms(run, reps=3),
            "bit_identical": True}
        del scan, fused, st, fst, dsh, cell
    emit({"phase": "sharded_engine", "envs": E, "windows_per_batch": K,
          **out})


def _prefix_equal(label, got, ref, windows):
    """A short run against the first ``windows`` windows of a longer run
    of its twin: results, each forwarder's sink, the LogDB rows and the
    replay export's rows so far, bit for bit."""
    rows = windows * E
    check(got["results"] == ref["results"][:windows],
          f"{label}: results differ from the twin's first {windows}")
    check(all(len(g) == rows and g == r[:rows]
              for g, r in zip(got["sinks"], ref["sinks"])),
          f"{label}: forwarder sinks differ from the twin's")
    check(len(got["db_rows"]) == rows
          and got["db_rows"] == ref["db_rows"][:rows],
          f"{label}: LogDB rows differ from the twin's")
    ea, eb = got["export"], ref["export"]
    check(ea["env_ids"] == eb["env_ids"], f"{label}: replay ids")
    for key in eb:
        if key != "env_ids":
            c = ea[key].shape[1]
            check(c == windows - 1 and ea[key].dtype == eb[key].dtype
                  and np.array_equal(ea[key], eb[key][:, :c]),
                  f"{label}: replay {key} differs from the twin's")


def system_shards(dev, tmp, refs):
    """(b) ``scan_fused_decide_sharded`` and ``scan_sharded`` for 2 batches
    at E = 256 on ``SYS_SHARDS`` logical shards, their async twins for 1,
    each held against the first batches of its unsharded twin's run in
    ``refs``; launches counted over the run."""
    out = {}
    runs = (("scan_fused_decide_sharded", "scan_fused_decide", 2),
            ("scan_sharded", "scan", 2),
            ("scan_fused_decide_async_sharded", "scan_fused_decide", 1),
            ("scan_async_sharded", "scan", 1))
    with logical_shards(SYS_SHARDS):
        for mode, twin, batches in runs:
            system = make_system(mode, dev, str(Path(tmp) / mode))
            check(system.mesh.size == SYS_SHARDS,
                  f"{mode}: {system.mesh.size} shards")
            n = batches * K
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = system.run_windows(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, by_impl = _read_launches()
            # the shards launch the pipeline kernels; rglru_scan runs in
            # the decide step: per shard in the fused modes, once a window
            # in scan's unsharded consume
            check_loop_launches(mode, {**launches, "rglru_scan": 0},
                                by_impl, SYS_SHARDS * n, rglru=0)
            want_rglru = SYS_SHARDS * n if system.fused_decide else n
            check(launches["rglru_scan"] == want_rglru,
                  f"{mode}: rglru_scan {launches['rglru_scan']}, expected "
                  f"{want_rglru}")
            got = loop_record(system, {"results": results})
            _prefix_equal(f"{mode} != {twin}", got, refs[twin], n)
            if system.fused_decide:
                cert = system.policy_certificate
                check(cert is not None
                      and cert.shard_widths == (E // SYS_SHARDS,),
                      f"{mode}: policy certificate {cert}")
            out[mode] = {"windows": n, "windows_per_s": n / wall,
                         "launches": launches, "twin": twin,
                         "twin_windows_per_s": refs[twin]["windows_per_s"],
                         "bit_identical_to_twin": True}
            system.db.close()
            system.stop()
    emit({"phase": "sharded_system", "shards": SYS_SHARDS, **out})


def elastic_shards(dev, tmp):
    """(c) An elastic pool in ``scan_fused_decide_sharded``: 4 envs in 4
    slots on 4 logical shards; a batch; a fifth env joins, which grows the
    pool to 8 slots on 8 shards; a batch. The 4 envs' results (batch 0),
    LogDB rows and replay rows equal a dense unsharded system's over them
    bit for bit."""
    slots, grown = EL_SHARDED
    stable = [f"bldg-{i}" for i in range(slots)]
    dense = make_system("scan_fused_decide", dev,
                        str(Path(tmp) / "el_sh_dense"), env_ids=stable)
    rd = dense.run_windows(2 * K)
    with logical_shards(grown):
        pool = make_system("scan_fused_decide_sharded", dev,
                           str(Path(tmp) / "el_sh_pool"), env_ids=stable,
                           slots=slots, elastic=True)
        check(pool.mesh.size == slots,
              f"elastic sharded: {pool.mesh.size} shards")
        rp = pool.run_windows(K)
        t0 = time.perf_counter()
        pool.attach_env("late-0")
        grow_ms = (time.perf_counter() - t0) * 1e3
        check(pool.env_slots == grown and pool.mesh.size == grown,
              f"elastic sharded: {pool.env_slots} slots on "
              f"{pool.mesh.size} shards, expected {grown} on {grown}")
        pool.run_windows(K)
    check(_strip(rp) == _strip(rd[:K]),
          "elastic sharded: batch 0 differs from the dense run")
    ed, ep = dense.export_replay("salt"), pool.export_replay("salt")
    at = {e: i for i, e in enumerate(ep["env_ids"])}
    rows = [at[e] for e in ed["env_ids"]]
    for key in ed:
        if key != "env_ids":
            check(np.array_equal(ed[key], ep[key][rows]),
                  f"elastic sharded: the stable envs' replay {key} differs")
    ids = {r[0] for r in _db_rows(dense)}      # the LogDB's own pseudonyms
    check([r for r in _db_rows(pool) if r[0] in ids] == _db_rows(dense),
          "elastic sharded: the stable envs' LogDB rows differ")
    emit({"phase": "sharded_elastic", "slots": [slots, grown],
          "shards": [slots, grown], "windows": 2 * K,
          "resizing_attach_ms": grow_ms, "stable_rows_bit_identical": True})
    for s_ in (dense, pool):
        s_.db.close()
        s_.stop()


def phase_sharded(dev, tmp, raw, refs):
    engine_shards(dev, raw)
    system_shards(dev, tmp, refs)
    elastic_shards(dev, tmp)


def phase_autotune(dev, tmp):
    """``scan_k="auto"`` in ``scan`` and ``scan_fused_decide`` at the loop
    config, k_grid (8, 16, 32), the default measure: the whole grid (the
    engine's windows/s alone, no source simulation), the chosen K and the
    calibration seconds; the choice must be the grid's argmax."""
    from repro_torch.core import autotune
    for mode in ("scan", "scan_fused_decide"):
        spans = []
        tune = autotune.tune_scan_params
        autotune.tune_scan_params = interval(tune, spans)
        try:
            system = make_system(mode, dev, str(Path(tmp) / f"auto_{mode}"),
                                 scan_k="auto",
                                 autotune={"k_grid": (8, 16, 32)})
        finally:
            autotune.tune_scan_params = tune
        tuned = system.tuned
        best = max(tuned.grid, key=lambda row: row[2])
        check((tuned.scan_k, tuned.mesh_devices) == best[:2]
              and system.scan_k == tuned.scan_k,
              f"autotune {mode}: chose {tuned.scan_k}, the grid's best is "
              f"{best}")
        emit({"phase": "autotune", "mode": mode, "tuned": tuned.as_dict(),
              "scan_k": system.scan_k,
              "calibration_s": spans[0][1] - spans[0][0]})
        system.db.close()
        system.stop()


# ------------------------------------------------------- online training
# the online_train phase: the loop config with the mlp policy and
# train="online" (PERF.md §4)
ONLINE_POLICY = ("mlp", {"hidden": 32})
TRAIN_BATCH = 128
# card step against the CPU step, norm-wise per leaf: max |card - cpu| <=
# STEP_REL * max |cpu| (tests/test_torch_train.py's bound against JAX)
STEP_REL = 1e-5
# a registry policy's decide on the card against the CPU, max abs error
# (the repo's single-module bound)
POLICY_TOL = 1e-5


def tree_bits_equal(a, b):
    from repro_torch.train import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def online_system(dev, tmp, tag, train):
    from repro_torch.runtime.policies import PolicyConfig
    kw = {}
    if train:
        kw = dict(train="online", train_cfg={
            "batch_size": TRAIN_BATCH, "checkpoint_every": 1,
            "checkpoint_dir": str(Path(tmp) / "online_ckpt")})
    return make_system("scan_fused_decide", dev,
                       str(Path(tmp) / f"online_{tag}"),
                       policy=PolicyConfig(*ONLINE_POLICY), **kw)


def drive_online(system, label):
    """``K * BATCHES`` windows of the training phase's main path through
    ``run_windows``, timed, with every kernel count set to 0 just before
    and read just after: locf n, window_agg 2n (all ``row``), rglru_scan 0
    (the mlp policy has no kernel). The batch loop's parts are timed by
    ``instrument``, and the trainer's ``dispatch`` + ``apply_pending``
    (the host side of training, inside the Manager's span) as ``train``.
    Returns the results, windows/s and ms a batch of each part."""
    spans = instrument(system)
    spans["train"] = []
    if system.trainer is not None:
        t = system.trainer
        t.dispatch = interval(t.dispatch, spans["train"])
        t.apply_pending = interval(t.apply_pending, spans["train"])
    n = K * BATCHES
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = system.run_windows(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_impl = _read_launches()
    check(len(results) == n, f"{label}: {len(results)} results")
    check_loop_launches(label, launches, by_impl, n, rglru=0)
    results = _strip(results)
    return {"results": results, "windows_per_s": n / wall,
            "launches": launches,
            **{f"{k}_ms_per_batch": sum(b - a for a, b in v) * 1e3 / BATCHES
               for k, v in spans.items()}}


def _versions_rows(system):
    return [r["policy_version"] for _, r in system.db.read_from()]


def _to_cpu(t):
    from repro_torch.train import tree
    return tree.map_(lambda x: x.cpu(), t)


def max_rel_err(got, want):
    """max over leaves of max |got - want| / max |want| (0 where both are
    all zeros; inf where only ``want`` is)."""
    from repro_torch.train import tree
    worst = 0.0
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        worst = max(worst, 0.0 if err == 0 else
                    (err / scale if scale else float("inf")))
    return worst


def profile_step(fn, reps=10, want=()):
    """Profiler device ms and device activities of one call, averaged over
    ``reps`` calls (taken again if a trace comes back empty or lacks a
    kernel named in ``want``; the check fails if every one lacks it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    missing = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy = _device_us(dev)
        missing = _missing(dev, want)
        if busy > 0 and not missing:
            return busy / reps / 1e3, sum(e.count for e in dev) / reps
    check(not missing, f"profile_step: every trace lacks kernels {missing}")
    return None, None


def host_launch_ms(fn, reps=20):
    """Median host time to launch ``fn``'s work (no wait for the card),
    the card drained before each call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def policy_decides(dev):
    """``mlp`` and ``rwkv6`` at E envs: three decide steps on the card
    against the same calls on the CPU (weights from one seed, built on the
    CPU and copied); max abs error of actions and carry."""
    from repro_torch.runtime.policies import build_policy
    g = torch.Generator().manual_seed(7)
    F, A = 8, 2
    out = {}
    for name, kw in (("mlp", {"hidden": 32}), ("rwkv6", {})):
        cpu = build_policy(name, F, A, E, device="cpu", **kw)
        gpu = build_policy(name, F, A, E, device=dev, **kw)
        cc = cpu.init_carry(E) if cpu.init_carry else None
        gc = gpu.init_carry(E) if gpu.init_carry else None
        err = 0.0
        for _ in range(3):
            f = torch.randn((E, F), generator=g)
            if cc is None:
                want, got = cpu(f), gpu(f.to(dev))
            else:
                want, cc = cpu.apply_carry(cpu.params, f, cc)
                got, gc = gpu.apply_carry(gpu.params, f.to(dev), gc)
                for k in cc:
                    err = max(err, float((gc[k].cpu() - cc[k]).abs().max()))
            check(got.device.type == "cuda", f"{name}: decided off the card")
            err = max(err, float((got.cpu() - want).abs().max()))
        check(err <= POLICY_TOL, f"{name} decide on the card vs the CPU: "
              f"max abs error {err} > {POLICY_TOL}")
        out[name] = err
    return out


def phase_online_train(dev, tmp):
    """``scan_fused_decide`` at the loop config with the mlp policy and
    ``train="online"`` (``TRAIN_BATCH`` rows a step), and without training,
    each for ``BATCHES`` batches, in the order off, on, on, off (each run
    a fresh system over the same windows; the two runs of each kind must
    be equal bit for bit). Checks: (a) a step on a fresh ring leaves params
    and optimizer state bit-identical and the version at 0; (b) two steps
    from the same inputs and indices are bit-equal; (c) one card step
    against the same step on the CPU within ``STEP_REL``; (d) batch 0 with
    training equals batch 0 without; (e) DB rows carry their batch's
    version, replay rows the version behind their action; (f)
    ``restore_training`` puts the checkpointed bits and version into the
    carry. Also the step's device time and activities, its host launch
    time, the host reads of a step and of ``apply_pending``, and the
    mlp/rwkv6 decide on the card against the CPU."""
    from repro_torch.core import replay as rp
    from repro_torch.train import tree

    runs, on_sys = {}, None
    for i, (tag, train) in enumerate((("off", False), ("on", True),
                                      ("on", True), ("off", False))):
        system = online_system(dev, tmp, f"{tag}{i}", train)
        rec = drive_online(system, f"online_train {tag} #{i}")
        if tag in runs:
            check(rec["results"] == runs[tag][0]["results"]
                  and _versions_rows(system) == runs[tag][0]["versions"],
                  f"online_train: the two {tag} runs differ")
        rec["versions"] = _versions_rows(system)
        runs.setdefault(tag, []).append(rec)
        if train and on_sys is None:
            on_sys = system           # checks (b)-(f) below
            continue
        system.db.close()
        system.stop()

    # (d) the first batch predates any applied step
    off, on = runs["off"][0], runs["on"][0]
    check(on["results"][:K] == off["results"][:K]
          and on["versions"][:K * E] == off["versions"][:K * E],
          "online_train (d): batch 0 with training != without")
    # (e) version attribution
    st = on_sys.train_stats()
    check((st["dispatched"], st["applied"], st["skipped_empty"])
          == (BATCHES, BATCHES - 1, 0) and on_sys.policy_version()
          == BATCHES - 1, f"online_train (e): counters {st}")
    check(on["versions"] == [j for j in range(BATCHES)
                             for _ in range(K * E)],
          "online_train (e): LogDB rows do not carry their batch's version")
    ver = on_sys.export_replay("salt")["version"]
    want = [0] * (K - 1) + [v for j in range(1, BATCHES)
                            for v in [j - 1] + [j] * (K - 1)]
    check(ver.shape == (E, K * BATCHES - 1)
          and bool((ver == np.asarray(want, np.int32)[None]).all()),
          "online_train (e): replay versions: only the first row banked "
          "in a batch may carry the previous version")
    check(all(np.isfinite(r["mean_reward"]) for r in on["results"]),
          "online_train: non-finite reward")

    t, ds = on_sys.trainer, on_sys._dstate
    replay = ds.replay
    es, ss = t.draw(replay)
    with count_fetches() as reads:
        a = t.step_fn(ds.policy, t.train_state, replay, es, ss)
        torch.cuda.synchronize()
    check(reads.calls == 0, f"online_train: the step read the card "
          f"{reads.calls} times")
    check(all(x.is_cuda for x in tree.leaves(a)),
          "online_train: a step output fell back to the CPU")
    check(bool(a[4]), "online_train: no data in a filled ring")
    # (b) determinism
    b = t.step_fn(ds.policy, t.train_state, replay, es, ss)
    check(tree_bits_equal(a, b), "online_train (b): two steps from the "
          "same inputs and indices differ")
    # (c) the same step on the CPU
    c = t.step_fn(_to_cpu(ds.policy), _to_cpu(t.train_state),
                  _to_cpu(replay), es.cpu(), ss.cpu())
    step_err = max_rel_err(a[:4], c[:4])
    check(step_err <= STEP_REL, f"online_train (c): card step vs CPU "
          f"step, max relative error {step_err} > {STEP_REL}")
    step_ms, step_acts = profile_step(
        lambda: t.step_fn(ds.policy, t.train_state, replay, *t.draw(replay)))
    launch_ms = host_launch_ms(
        lambda: t.step_fn(ds.policy, t.train_state, replay, *t.draw(replay)))
    # the last checkpoint is the last applied step's (version BATCHES - 1),
    # whose params the carry served in the last batch
    saved_policy = on_sys.snapshot_policy()
    # the boundary's own host reads, without a checkpoint's copies
    t.checkpoint_every = 0
    with count_fetches() as reads:
        on_sys._dstate = t.flush_pending(on_sys._dstate)
    apply_reads = reads.calls
    check(apply_reads == 1 and on_sys.policy_version() == BATCHES,
          f"online_train: apply_pending read the card {apply_reads} times, "
          "expected 1 (has_data)")
    on_sys.db.close()
    on_sys.stop()           # closes the trainer: its checkpoints are on disk

    # (a) and (f) on a fresh system over the same checkpoint directory
    fresh = online_system(dev, tmp, "restore", True)
    ds = fresh._dstate
    policy0 = tree.map_(torch.clone, ds.policy)
    state0 = tree.map_(torch.clone, fresh.trainer.train_state)
    fresh.trainer.dispatch(ds)
    check(fresh.trainer.apply_pending(ds) is ds
          and fresh.trainer.stats["skipped_empty"] == 1
          and fresh.policy_version() == 0 and int(ds.version) == 0
          and tree_bits_equal(ds.policy, policy0)
          and tree_bits_equal(fresh.trainer.train_state, state0),
          "online_train (a): a step on a fresh ring moved the state")
    restored = fresh.restore_training()
    check(restored is not None and restored[0] == BATCHES - 1,
          f"online_train (f): restored {restored and restored[0]}")
    check(fresh.policy_version() == BATCHES - 1
          and int(fresh._dstate.version) == BATCHES - 1
          and tree_bits_equal(fresh._dstate.policy, saved_policy),
          "online_train (f): the carry does not hold the saved bits")
    fresh.db.close()
    fresh.stop()

    decide_err = policy_decides(dev)
    wps = {tag: [r["windows_per_s"] for r in runs[tag]] for tag in runs}
    mean = {tag: sum(v) / len(v) for tag, v in wps.items()}
    parts = {f"{k}_ms_per_batch_{tag}": [r[f"{k}_ms_per_batch"]
                                         for r in runs[tag]]
             for k in ("pump", "assemble", "manager", "train")
             for tag in ("off", "on")}
    emit({"phase": "online_train", "policy": ONLINE_POLICY[0],
          "hidden": ONLINE_POLICY[1]["hidden"], "batch_size": TRAIN_BATCH,
          "windows": K * BATCHES, "windows_per_batch": K,
          "dispatched": st["dispatched"], "applied": st["applied"],
          "skipped_empty": st["skipped_empty"],
          "last_loss": st["last_loss"], "last_gnorm": st["last_gnorm"],
          "step_device_ms": step_ms, "step_device_activities": step_acts,
          "step_host_launch_ms": launch_ms,
          "step_host_reads": 0, "apply_pending_host_reads": apply_reads,
          "card_vs_cpu_step_max_rel_err": step_err,
          "order": ["off", "on", "on", "off"],
          "windows_per_s_off": wps["off"], "windows_per_s_on": wps["on"],
          "windows_per_s_off_mean": mean["off"],
          "windows_per_s_on_mean": mean["on"],
          "on_vs_off": mean["on"] / mean["off"] - 1.0, **parts,
          "launches": runs["on"][0]["launches"],
          "policy_decide_max_abs_err": decide_err,
          "checks": ["a", "b", "c", "d", "e", "f"]})


# ---------------------------------------------------- elastic, modular
# the elastic phase (PERF.md §4): the loop config over 160 "stable" envs,
# alone (dense) and in a pool of 256 slots that churn grows to 512
EL_STABLE, EL_SLOTS, EL_CHURN, EL_BATCHES = 160, 256, 32, 5


def run_batches(system, label, before=()):
    """K-window batches through ``run_windows``, one a call: ``before[j]``
    (a membership change, or None) runs ahead of batch j, outside the
    timed part. Each batch's kernel counts are set to 0 just before it and
    read just after, and checked (``check_loop_launches``). Returns the
    results, the launches a batch and the seconds of the batches alone."""
    results, launches, wall = [], [], 0.0
    for j, op in enumerate(before):
        if op is not None:
            op()
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results += system.run_windows(K)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        got, by_impl = _read_launches()
        check_loop_launches(f"{label} batch {j}", got, by_impl, K)
        launches.append(got)
    return results, launches, wall


def pool_bytes(system):
    """Device bytes of the pool's trees: the pipeline state and the fused
    decide carry, the replay ring included."""
    from repro_torch.train import tree
    return sum(t.numel() * t.element_size()
               for t in tree.leaves(system.state)
               + tree.leaves(system._dstate))


def _ms_stats(xs):
    return {"calls": len(xs), "median_ms": statistics.median(xs),
            "max_ms": max(xs), "total_ms": sum(xs)} if xs else {"calls": 0}


def phase_elastic(dev, tmp, dense_profile):
    """Elastic slot pools at the loop config in ``scan_fused_decide``.

    A dense system over the 160 stable envs runs 5 batches. (a) The same
    envs in a 256-slot elastic pool: its first 2 batches' results equal
    the dense run's bit for bit; (b) the same in ``scan`` mode. (c) A fresh
    256-slot pool, the stable envs plus 32 churn envs: batch; detach the
    32; batch; attach 32 new envs (into the recycled slots) and 64 more
    (the pool is full); batch; attach one more (the pool grows to 512);
    batch; batch. The stable envs' replay rows equal the dense run's bit
    for bit, the recycled slots hold nothing of their former tenants, and
    the new env sits in slot 256. Every batch of every run launches locf
    K, window_agg 2K and rglru_scan K times, all row. One more batch of
    the 256-slot pool runs under the profiler, beside ``dense_profile``
    (the fused_decide phase's profiled batch: a dense system of the same
    width), so the device activities and busy time the masks add show."""
    stable = [f"bldg-{i}" for i in range(EL_STABLE)]
    churn = [f"churn-{i}" for i in range(EL_CHURN)]
    # enough new envs to fill the pool (the recycled slots first), and one
    late = [f"late-{i}" for i in range(EL_SLOTS - EL_STABLE + 1)]
    mode = "scan_fused_decide"

    def system(tag, envs, **kw):
        return make_system(kw.pop("mode", mode), dev,
                           str(Path(tmp) / f"elastic_{tag}"),
                           env_ids=list(envs), **kw)

    dense = system("dense", stable)
    spans_d = instrument(dense)
    rd, ld, wall_d = run_batches(dense, "elastic dense", [None] * EL_BATCHES)
    export_d = dense.export_replay("salt")
    dense.db.close()
    dense.stop()
    del dense

    for m, label in ((mode, "a"), ("scan", "b")):
        pool = system(f"static_{m}", stable, slots=EL_SLOTS, elastic=True,
                      mode=m)
        got, _, _ = run_batches(pool, f"elastic ({label})", [None] * 2)
        check(_strip(got) == _strip(rd[:2 * K]),
              f"elastic ({label}, {m}): the pool's first 2 batches differ "
              "from the dense run's")
        if m == mode:
            prof = profile_batch(pool, "elastic_profile")
            emit({"phase": "elastic_vs_dense_profile",
                  "slots": EL_SLOTS, "live": EL_STABLE,
                  **{k: [prof[k], dense_profile[k]]
                     for k in ("device_kernels", "device_busy_ms",
                               "device_idle_share", "wall_ms")}})
        pool.db.close()
        pool.stop()
        del pool

    pool = system("churn", stable + churn, slots=EL_SLOTS, elastic=True)
    spans_c = instrument(pool)
    spans_m = {"attach": [], "detach": [], "resize": []}
    pool.resize = interval(pool.resize, spans_m["resize"])
    attach = interval(pool.attach_env, spans_m["attach"])
    detach = interval(pool.detach_env, spans_m["detach"])
    bytes_256 = pool_bytes(pool)
    slot_of = {}

    def detach_churn():
        for e in churn:
            slot_of[e] = detach(e)

    def attach_late():
        for e in late[:-1]:
            slot_of[e] = attach(e)

    def attach_one():
        slot_of[late[-1]] = attach(late[-1])

    rc, lc, wall_c = run_batches(pool, "elastic (c)", [
        None, detach_churn, attach_late, attach_one, None])
    export_c = pool.export_replay("salt")
    recycled = [slot_of[e] for e in churn]
    check([slot_of[e] for e in late[:EL_CHURN]] == recycled,
          "elastic (c): the new envs did not take the recycled slots")
    check(pool.env_slots == 2 * EL_SLOTS and slot_of[late[-1]] == EL_SLOTS,
          f"elastic (c): {pool.env_slots} slots, the new env in slot "
          f"{slot_of[late[-1]]}; expected {2 * EL_SLOTS} and {EL_SLOTS}")
    # the stable envs' rows equal the dense run's, joined on exported ids
    at = {e: i for i, e in enumerate(export_c["env_ids"])}
    rows_c = [at[e] for e in export_d["env_ids"]]
    for key in ("obs", "actions", "rewards", "next_obs", "tick_idx",
                "times", "valid"):
        a, b = export_d[key], export_c[key][rows_c]
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"elastic (c): stable envs' replay {key} differs from the "
              "dense run's")
    # recycled slots: only the new tenants' transitions, from the window
    # after their attach (batch 2's first window has no predecessor)
    first_tick = 2 * K + 1
    gone = {e for e in churn} & set(pool._export_env_ids())
    valid, ticks = export_c["valid"][recycled], export_c["tick_idx"][recycled]
    check(not gone and not (valid & (ticks < first_tick)).any()
          and (valid.sum(1) == 3 * K - 1).all(),
          f"elastic (c): recycled slots keep a trace of their former "
          f"tenants (ids {sorted(gone)[:3]}, valid rows per slot "
          f"{sorted(set(valid.sum(1).tolist()))})")
    check(all(np.isfinite(r["mean_reward"]) for r in rc),
          "elastic (c): non-finite reward")
    bytes_512 = pool_bytes(pool)
    ms = {k: [(b - a) * 1e3 for a, b in v] for k, v in spans_m.items()}
    per_batch = lambda spans: {
        f"{k}_ms_per_batch": sum(b - a for a, b in v) * 1e3 / EL_BATCHES
        for k, v in spans.items()}
    emit({"phase": "elastic", "mode": mode, "stable_envs": EL_STABLE,
          "slots": [EL_SLOTS, pool.env_slots], "windows": K * EL_BATCHES,
          "windows_per_batch": K,
          "static_subset_bit_identical": {mode: True, "scan": True},
          "stable_rows_bit_identical": True,
          "launches_per_batch_dense": ld, "launches_per_batch_churn": lc,
          "windows_per_s_dense": K * EL_BATCHES / wall_d,
          "windows_per_s_churn": K * EL_BATCHES / wall_c,
          "dense": per_batch(spans_d), "churn": per_batch(spans_c),
          "host_ms": {k: _ms_stats(v) for k, v in ms.items()},
          "resizing_attach_ms": ms["attach"][-1],
          "pool_device_bytes": {str(EL_SLOTS): bytes_256,
                                str(2 * EL_SLOTS): bytes_512}})
    pool.db.close()
    pool.stop()


def phase_modular(dev, tmp, fused):
    """``modular`` over the fused phase's 32 windows: every stage its own
    call, the host waiting for the card after each. Every result but
    ``latency_s``, the LogDB rows and the replay export equal ``fused``'s
    bit for bit; locf K, window_agg 2K and rglru_scan K launches."""
    system = make_system("modular", dev, str(Path(tmp) / "modular"))
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = system.run_windows(K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_impl = _read_launches()
    check_loop_launches("modular", launches, by_impl, K)
    check(_strip(got) == _strip(fused["results"]),
          "modular != fused in the per-window results")
    check(_db_rows(system) == fused["db_rows"],
          "modular != fused in LogDB rows")
    exp = system.export_replay("salt")
    for key in exp:
        same = exp[key] == fused["export"][key] if key == "env_ids" \
            else np.array_equal(exp[key], fused["export"][key])
        check(same, f"modular != fused: replay {key}")
    emit({"phase": "modular", "windows": K, "windows_per_s": K / wall,
          "fused_windows_per_s": fused["windows_per_s"],
          "launches": launches, "launches_by_impl": by_impl,
          "bit_identical_to_fused": True})
    system.db.close()
    system.stop()


def phase_harmonize(raw):
    """The harmonize op entry point on each of the K windows of one batch
    the scan system assembled (window-relative: every window starts at 0),
    held against its plain version and against the pipeline's own
    ``harmonize_segment(agg="mean")``. Returns the launches counted."""
    from repro_torch.core.frame import RawWindow
    from repro_torch.core.harmonize import harmonize_segment, tick_grid
    from repro_torch.kernels.harmonize import ops as hz_ops
    from repro_torch.kernels.harmonize.ref import harmonize_ref
    from repro_torch.kernels.rows import aligned

    k, e, s, m = raw.values.shape
    R = e * s
    ws = torch.zeros((e,), dtype=torch.float32, device=raw.values.device)

    def window(j):
        return hz_ops.harmonize(raw.values[j], raw.timestamps[j],
                                raw.valid[j], ws, tick_s=TICK_S,
                                n_ticks=N_TICKS)

    impl, vec = hz_ops.impl_for(m, aligned(raw.values[0], raw.timestamps[0],
                                           raw.valid[0]))
    hz_ops.LAUNCHES = 0
    hz_ops.LAUNCHES_BY_IMPL.update(warp=0)
    torch.cuda.synchronize()
    outs = [window(j) for j in range(k)]
    torch.cuda.synchronize()
    launches = hz_ops.LAUNCHES
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    check(launches == k, f"harmonize: {launches} launches, expected {k}")
    check(by_impl == {impl: k},
          f"harmonize: launches by instance {by_impl}, expected {impl} {k}")
    traced = traced_kernels(lambda: window(0), "harmonize")
    check(len(traced) == 1 and f"harmonize_{impl}_kernel" in traced[0],
          f"harmonize: trace shows {traced}, expected harmonize_{impl}_kernel")
    batch_ms = device_ms(lambda: [window(j) for j in range(k)], reps=5,
                         want=("harmonize",))
    err_plain = err_seg = 0.0
    observed = 0
    grid = tick_grid(ws, TICK_S, N_TICKS)
    for j, (out, obs) in enumerate(outs):
        ref, ref_obs = harmonize_ref(
            raw.values[j].reshape(R, m), raw.timestamps[j].reshape(R, m),
            raw.valid[j].reshape(R, m), ws.repeat_interleave(s), TICK_S,
            N_TICKS)
        seg, seg_obs = harmonize_segment(
            RawWindow(raw.values[j], raw.timestamps[j], raw.valid[j]), grid,
            TICK_S, "mean")
        check(torch.equal(obs.reshape(R, N_TICKS), ref_obs),
              f"harmonize window {j}: observed differs from plain")
        check(torch.equal(obs, seg_obs),
              f"harmonize window {j}: observed differs from harmonize_segment")
        torch.testing.assert_close(out.reshape(R, N_TICKS), ref, rtol=1e-4,
                                   atol=1e-5)
        seq, _ = sequential_harmonize(
            raw.values[j].reshape(R, m), raw.timestamps[j].reshape(R, m),
            raw.valid[j].reshape(R, m), ws.repeat_interleave(s), TICK_S,
            N_TICKS)
        check(bits_equal(out.reshape(R, N_TICKS), seq),
              f"harmonize window {j}: differs from the sequential loop")
        torch.testing.assert_close(out, seg, rtol=1e-4, atol=1e-5)
        err_plain = max(err_plain, (out.reshape(R, N_TICKS) - ref).abs()
                        .max().item())
        err_seg = max(err_seg, (out - seg).abs().max().item())
        observed += int(obs.sum())
    observed_frac = observed / (k * R * N_TICKS)
    emit({"phase": "harmonize_system", "windows": k, "envs": e,
          "streams": s, "max_samples": m, "ticks": N_TICKS,
          "launches": launches, "launches_by_impl": by_impl,
          "impl": impl, "vec": vec, "traced_kernel": traced[0],
          "device_us_per_batch": (None if batch_ms is None
                                  else batch_ms * 1e3),
          "bit_equal_sequential": True, "max_abs_err_vs_plain": err_plain,
          "max_abs_err_vs_segment": err_seg,
          "observed_frac": observed_frac})
    # samples outside every tick (e.g. timestamps not window-relative)
    # would leave all three versions at zeros and equal; the sources here
    # fill ~63% of (row, tick) cells
    check(observed_frac >= 0.3,
          f"harmonize: only {observed_frac:.3f} of (row, tick) cells "
          f"observed")
    return launches


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _serve_drain(model, tag):
    """A ``ServeEngine`` drain at ``launch/serve.py``'s defaults (SERVE),
    every engine step timed (host clock, synchronized). The timing hook
    makes a cycle engine -> hook -> engine: the caller collects it."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    engine = ServeEngine(model, SERVE["slots"], SERVE["max_seq"])
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(
                1, cfg.vocab_size, (SERVE["prompt_len"],)).astype(np.int32),
                    max_new_tokens=SERVE["new_tokens"])
            for i in range(SERVE["requests"])]
    steps = []
    step = engine._step_masked

    def timed_step(tokens, mask):
        out, ms = _sync_ms(lambda: step(tokens, mask))
        steps.append(ms)
        return out
    engine._step_masked = timed_step
    _, wall_ms = _sync_ms(lambda: engine.run_until_drained(reqs))
    n_tok = sum(len(r.tokens) for r in reqs)
    check(all(r.done and r.finish_reason == "length" and
              len(r.tokens) == SERVE["new_tokens"] for r in reqs),
          f"{tag}: a request did not complete")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          f"{tag}: token out of range")
    check(engine.stats["admitted"] == engine.stats["retired"] ==
          SERVE["requests"] and engine.stats["timeouts"] == 0,
          f"{tag}: stats {engine.stats}")
    return {**SERVE, "completed": len(reqs), "tokens": n_tok,
            "wall_s": wall_ms / 1e3, "tokens_per_s": n_tok / (wall_ms / 1e3),
            "engine_ticks": engine.stats["ticks"], "decode_steps": len(steps),
            "ms_per_decode_step": statistics.median(steps),
            "stats": engine.stats}


def phase_lm(dev):
    """qwen3-0.6b at full width: prefill, decode against prefill, and the
    serving engine. Returns the flash-attention launches of one prefill."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import LM

    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.vocab_size, cfg.dtype)
          == (28, 1024, 16, 8, 128, 151936, "bfloat16"),
          f"{LM_ARCH}: not the full-width config")
    model, init_ms = _sync_ms(lambda: LM(cfg, device=dev, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == model.param_count(), "lm: parameter count differs")
    emit({"phase": "lm_init", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params": n_params, "param_bytes": model.param_bytes(),
          "init_ms": init_ms})

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (LM_B, LM_S), generator=g,
                         device=dev, dtype=torch.int32)
    model.prefill({"tokens": toks[:, :256]})   # warm-up: library handles
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    (full, _), first_ms = _sync_ms(lambda: model.prefill({"tokens": toks}))
    launches = fa_ops.LAUNCHES
    by_impl = dict(fa_ops.LAUNCHES_BY_IMPL)
    check(launches == cfg.n_layers,
          f"lm: {launches} flash_attention launches in one prefill, "
          f"expected {cfg.n_layers}")
    check(by_impl == {"wgmma": cfg.n_layers, "scalar": 0},
          f"lm: flash_attention launches by impl {by_impl}, expected all "
          f"{cfg.n_layers} on wgmma")
    check(full.shape == (LM_B, cfg.vocab_size) and full.dtype ==
          torch.float32 and bool(torch.isfinite(full).all()),
          "lm: prefill logits not finite float32 (B, V)")
    walls = [_sync_ms(lambda: model.prefill({"tokens": toks}))[1]
             for _ in range(3)]
    prefill_ms = statistics.median(walls)
    emit({"phase": "lm_prefill", "batch": LM_B, "seq": LM_S,
          "flash_attention_launches": launches,
          "flash_attention_launches_by_impl": by_impl,
          "first_wall_ms": first_ms,
          "wall_ms": prefill_ms, "wall_ms_runs": walls,
          "tokens_per_s": LM_B * LM_S / (prefill_ms / 1e3)})

    # decode against prefill: prefill S - 8 tokens with room for the rest,
    # decode the last 8, compare with the full prefill's last logits
    _, cache = model.prefill({"tokens": toks[:, :LM_S - LM_TAIL]},
                             max_seq=LM_S + 1)
    step_ms = []
    for t in range(LM_S - LM_TAIL, LM_S):
        (logits, cache), ms = _sync_ms(lambda: model.decode_step(
            {"tokens": toks[:, t:t + 1]}, cache))
        step_ms.append(ms)
    check(bool((cache["lengths"] == LM_S).all()), "lm: decode lengths")
    diff = (logits - full).abs().max().item()
    top2 = full.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = logits.argmax(-1) == full.argmax(-1)
    emit({"phase": "lm_decode_vs_prefill", "prefill_tokens": LM_S - LM_TAIL,
          "decode_steps": LM_TAIL, "cache_len": LM_S + 1,
          "max_abs_diff": diff, "bound": LM_DECODE_BOUND,
          "argmax_agree": int(agree.sum()), "rows": LM_B,
          "top2_gap_min": gap.min().item(),
          "decode_ms_per_step": statistics.median(step_ms)})
    check(bool(torch.isfinite(logits).all()), "lm: decode logits not finite")
    check(diff <= LM_DECODE_BOUND,
          f"lm: decode vs prefill max abs diff {diff} > {LM_DECODE_BOUND}")
    check(bool((agree | (gap <= LM_DECODE_BOUND)).all()),
          "lm: decode and prefill disagree on a clear argmax")
    del cache

    emit({"phase": "lm_serve", **_serve_drain(model, "serve")})
    gc.collect()   # the drain's timing hook held a cycle to the model

    # last, so that no timing above runs after a profiler session: where
    # one prefill's and one serving decode step's device time goes
    cache = model.init_cache(SERVE["slots"], SERVE["max_seq"])
    tok = torch.ones((SERVE["slots"], 1), dtype=torch.int32, device=dev)
    for name, fn, want in (
            ("prefill", lambda: model.prefill({"tokens": toks}),
             {FA_KERNELS["wgmma"][1]: cfg.n_layers}),
            ("decode_step", lambda: model.decode_step({"tokens": tok}, cache),
             {})):
        emit({"phase": f"lm_profile_{name}", **_profile_step(fn, "lm",
                                                             want)})
    del model, cache
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- LM model families
# every other family of the registry at its published widths (PERF.md §4)
FAMILIES = ("recurrentgemma-2b", "rwkv6-1.6b", "moonshot-v1-16b-a3b",
            "phi3.5-moe-42b-a6.6b", "musicgen-medium", "internvl2-26b")
# rwkv6's chunked wkv length, timed beside the sequential recurrence
RWKV_CHUNK = 64
# the relations (decode against prefill; rwkv6's chunked against its
# sequential wkv) are held to tests/test_models.py's bound per element,
# |a - b| <= FAMILY_ATOL + FAMILY_RTOL * |b|, in a float32 twin of each
# family (phase_f32_relations). In bfloat16 they are reported only: the
# two sides round hidden states at other places by the reference's own
# design (decode rounds p to bfloat16 before PV, prefill's conv rounds per
# tap, decode contracts the taps at once), a near-tie of the MoE router
# flips on such a rounding, and 26-48 layers amplify it (PERF.md §6)
FAMILY_ATOL = FAMILY_RTOL = 2e-2
# device memory left free beside a model's weights when its depth is fitted
# to the card (phi3.5-moe's 83.7 GB in bfloat16 is more than the card; in
# float32 most families are): the init's float32 draw of the largest leaf
# (phi3.5-moe's expert stack, 1.7 GB), activations, caches, the MoE buffer,
# and room for the profiler (at 10 GiB phi3.5 fitted 28 layers, and a
# trace of its prefill lost a kernel)
FIT_RESERVE_BYTES = 12 << 30


def _fit_depth(cfg):
    """``cfg`` with as many of its layers as fit in the card's free memory
    beside FIT_RESERVE_BYTES (all of them where they fit), never less than
    one whole period of its layer pattern."""
    import dataclasses

    from repro_torch.models import param as P
    from repro_torch.models.model import param_defs
    free = torch.cuda.mem_get_info()[0] - FIT_RESERVE_BYTES
    n = cfg.n_layers
    while n > len(cfg.layer_pattern) and P.bytes_of(param_defs(
            dataclasses.replace(cfg, n_layers=n))) > free:
        n -= 1
    return dataclasses.replace(cfg, n_layers=n)


def _family_inputs(cfg, g, dev, B, S):
    """Seeded inputs of a prefill of S positions in the model's dtype:
    frames for musicgen, 256 patches and S - 256 tokens for internvl2,
    tokens otherwise."""
    from repro_torch.models.layers import dtype_of
    dt = dtype_of(cfg.dtype)
    if cfg.frontend == "embeddings":
        return {"frames": torch.randn((B, S, cfg.d_model), generator=g,
                                      device=dev).to(dt)}
    n_tok = S - (cfg.n_patches if cfg.frontend == "vlm" else 0)
    out = {"tokens": torch.randint(1, cfg.vocab_size, (B, n_tok),
                                   generator=g, device=dev,
                                   dtype=torch.int32)}
    if cfg.frontend == "vlm":
        out["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                     generator=g, device=dev).to(dt)
    return out


def _seq_key(cfg):
    return "frames" if cfg.frontend == "embeddings" else "tokens"


def _moe_dropped(model, fn):
    """Run ``fn`` with the model's MoE counts on; returns its output and
    the (dropped, total) assignments over every MoE call it made."""
    model.moe_counts = []
    out = fn()
    counts, model.moe_counts = model.moe_counts, None
    if not counts:
        return out, (0, 0)
    dropped, total = torch.stack(counts).sum(0).tolist()
    return out, (int(dropped), int(total))


def _no_drop(cfg):
    """MoE at a capacity that cannot drop (C = T whatever the routing):
    decode (C = 1 at batch 1) equals prefill only where neither drops."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts /
        cfg.moe.experts_per_token))


def _relative_err(a, b):
    """max |a - b| / (FAMILY_ATOL + FAMILY_RTOL |b|): <= 1 within the
    bound."""
    return ((a - b).abs() / (FAMILY_ATOL + FAMILY_RTOL * b.abs())).max() \
        .item()


def _decode_vs_prefill(model, sub, key):
    """Prefill all but the last ``LM_TAIL`` positions of ``sub`` with room
    for the rest, decode those one at a time, and compare the last step's
    logits with the full prefill's: max abs difference, its ratio to the
    bound, argmax agreement, the MoE assignments dropped on either side,
    and the decode step's median wall ms."""
    n = sub[key].shape[1]
    (full, _), d_full = _moe_dropped(model, lambda: model.prefill(sub))
    head = {**sub, key: sub[key][:, :n - LM_TAIL]}
    (_, cache), d_head = _moe_dropped(
        model, lambda: model.prefill(head, max_seq=LM_S + 1))
    steps, dropped = [], d_full[0] + d_head[0]
    for t in range(n - LM_TAIL, n):
        ((logits, cache), d), ms = _sync_ms(lambda: _moe_dropped(
            model, lambda: model.decode_step({key: sub[key][:, t:t + 1]},
                                             cache)))
        dropped += d[0]
        steps.append(ms)
    check(bool((cache["lengths"] == LM_S).all()), "decode lengths")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    top2 = full.topk(2, dim=-1).values
    return {"rows": full.shape[0], "prefill_positions": LM_S - LM_TAIL,
            "decode_steps": LM_TAIL,
            "max_abs_diff": (logits - full).abs().max().item(),
            "err_over_bound": _relative_err(logits, full),
            "argmax_agree": int((logits.argmax(-1) ==
                                 full.argmax(-1)).sum()),
            "top2_gap_min": (top2[:, 0] - top2[:, 1]).min().item(),
            "max_abs_logit": full.abs().max().item(), "dropped": dropped,
            "decode_ms_per_step": statistics.median(steps)}


def phase_f32_relations(dev, tag, full_cfg):
    """A float32 twin of the family (its own seeded draw) at the published
    widths, its depth fitted to the card (listed in the line), at batch 1
    and at a capacity that cannot drop: decode against prefill, and for
    RWKV-6 the chunked wkv against the sequential one, each within the
    bound. The bfloat16 model must be freed first."""
    import dataclasses

    from repro_torch.models import LM
    cfg = _fit_depth(_no_drop(dataclasses.replace(
        full_cfg, dtype="float32", param_dtype="float32")))
    rwkv = "rwkv" in cfg.layer_pattern
    model = LM(cfg, device=dev, seed=0, rwkv_chunk=RWKV_CHUNK if rwkv else 0)
    g = torch.Generator(device=dev).manual_seed(2)
    sub = _family_inputs(cfg, g, dev, 1, LM_S)
    key = _seq_key(cfg)
    rel = _decode_vs_prefill(model, sub, key)
    out = {"phase": tag, "step": "f32_relations",
           "layers": f"{cfg.n_layers} of {full_cfg.n_layers}",
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
           "bound": f"{FAMILY_ATOL} + {FAMILY_RTOL} |prefill|",
           "decode_vs_prefill": rel}
    if rwkv:
        chunked, _ = model.prefill(sub)
        model.rwkv_chunk = 0
        seq, _ = model.prefill(sub)
        out["chunked_vs_sequential"] = {
            "max_abs_diff": (chunked - seq).abs().max().item(),
            "err_over_bound": _relative_err(chunked, seq)}
    emit(out)
    check(rel["dropped"] == 0, f"{tag}: float32 decode vs prefill dropped "
          f"{rel['dropped']} assignments")
    check(rel["err_over_bound"] <= 1.0, f"{tag}: float32 decode vs prefill "
          f"{rel['err_over_bound']} x the bound")
    if rwkv:
        ratio = out["chunked_vs_sequential"]["err_over_bound"]
        check(ratio <= 1.0, f"{tag}: float32 chunked vs sequential {ratio} "
              "x the bound")


def _profile_step(fn, name, want, tries=3):
    """One profiled call (device activity only: host-side tracing of a
    prefill's ~30,000 launches cost ~25 s and inflated the wall): wall,
    device busy ms and idle share, kernel count and the largest device
    items; ``want`` maps a kernel-name part to the launches the trace must
    show of it. The caching allocator's free blocks are released first
    (with the card nearly full a trace lost one of 28 kernels). A
    trace that lost kernels launched through the ctypes library (PERF.md
    §7) is taken again, up to ``tries`` times, then the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _sync_ms(fn)
        devs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        traced = {}
        for part in want:
            hits = [e for e in devs if part in e.key]
            traced[part] = {"kernels": sorted({e.key for e in hits}),
                            "launches": sum(e.count for e in hits),
                            "device_ms": sum(e.self_device_time_total
                                             for e in hits) / 1e3}
        if all(traced[p]["launches"] == n for p, n in want.items()):
            break
    for part, n in want.items():
        check(traced[part]["launches"] == n,
              f"{name}: the trace shows {traced[part]['launches']} "
              f"launches of {part} kernels ({traced[part]['kernels']}), "
              f"expected {n}")
    top = sorted(devs, key=lambda e: -e.self_device_time_total)[:6]
    busy = _device_us(devs) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "traces": attempt,
            "device_idle_share": 1 - busy / wall,
            "device_kernels": sum(e.count for e in devs), "traced": traced,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}


def phase_lm_family(dev, arch):
    """One model family at its published widths with seeded bfloat16
    weights, its depth fitted to the card (``_fit_depth``): prefill 4 x
    2048 positions with its kernel launches counted (checked against its
    layers and in a profiler trace), two prefills bit for bit (MoE: the
    dropped share), decode against prefill (reported), a ServeEngine
    drain for token input and a profiled decode step; then the float32
    twin's relations (checked). Returns the prefill's launches per
    kernel."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, RGLRU
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.models import LM

    tag = f"lm_family_{arch}"
    full = get_config(arch)
    check(full.dtype == "bfloat16", f"{tag}: dtype {full.dtype}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = _fit_depth(full)
    kinds = cfg.layer_kinds
    n_attn = sum(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in kinds)
    n_rglru = sum(k == RGLRU for k in kinds)
    moe = cfg.moe is not None
    model, init_ms = _sync_ms(lambda: LM(
        cfg, device=dev, seed=0,
        rwkv_chunk=RWKV_CHUNK if "rwkv" in cfg.layer_pattern else 0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == model.param_count(), f"{tag}: parameter count")
    emit({"phase": tag, "step": "init", "source": cfg.source,
          "layers": f"{cfg.n_layers} of {full.n_layers}",
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "experts": cfg.moe.n_experts if moe else None,
          "experts_per_token": cfg.moe.experts_per_token if moe else None,
          "frontend": cfg.frontend, "dtype": cfg.dtype, "params": n_params,
          "param_bytes": model.param_bytes(), "init_ms": init_ms,
          "device_bytes_before": before,
          "device_bytes_allocated": torch.cuda.memory_allocated()})

    g = torch.Generator(device=dev).manual_seed(1)
    inputs = _family_inputs(cfg, g, dev, LM_B, LM_S)
    key = _seq_key(cfg)
    # warm-up on a short prompt (library handles, the kernels' first load)
    model.prefill({**inputs, key: inputs[key][:, :256]})
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    rglru_ops.LAUNCHES = 0
    (first, dropped), first_ms = _sync_ms(
        lambda: _moe_dropped(model, lambda: model.prefill(inputs)))
    launches = {"flash_attention": fa_ops.LAUNCHES,
                "rglru_scan": rglru_ops.LAUNCHES}
    check(launches == {"flash_attention": n_attn, "rglru_scan": n_rglru},
          f"{tag}: prefill launches {launches}, expected {n_attn} "
          f"flash_attention and {n_rglru} rglru_scan")
    check(fa_ops.LAUNCHES_BY_IMPL == {"wgmma": n_attn, "scalar": 0},
          f"{tag}: flash_attention by impl {fa_ops.LAUNCHES_BY_IMPL}")
    logits, cache = first
    check(logits.shape == (LM_B, cfg.vocab_size) and bool(
        torch.isfinite(logits).all()), f"{tag}: prefill logits")
    check(bool((cache["lengths"] == LM_S).all()), f"{tag}: lengths")
    runs = []
    for _ in range(3):
        out, ms = _sync_ms(lambda: model.prefill(inputs))
        runs.append(ms)
    check(tree_bits_equal(first, out), f"{tag}: two prefills differ")
    del out, first, cache
    wall = statistics.median(runs)
    line = {"phase": tag, "step": "prefill", "batch": LM_B, "seq": LM_S,
            "launches": launches, "first_wall_ms": first_ms,
            "wall_ms": wall, "wall_ms_runs": runs,
            "tokens_per_s": LM_B * LM_S / (wall / 1e3),
            "bit_equal_twice": True}
    if moe:
        line.update(dropped_assignments=dropped[0], assignments=dropped[1],
                    dropped_share=dropped[0] / dropped[1])
    if model.rwkv_chunk:
        # the sequential recurrence beside the chunked one
        model.rwkv_chunk = 0
        (seq, _), seq_ms = _sync_ms(lambda: model.prefill(inputs))
        model.rwkv_chunk = RWKV_CHUNK
        line.update(chunk=RWKV_CHUNK, sequential_wall_ms=seq_ms,
                    chunked_vs_sequential_max_abs=(
                        seq - logits).abs().max().item())
        del seq
    emit(line)

    # decode against prefill in bfloat16, reported (see FAMILY_ATOL); MoE
    # at batch 1 and at a capacity that cannot drop
    model.cfg = _no_drop(cfg)
    rows = slice(0, 1) if moe else slice(0, LM_B)
    rel = _decode_vs_prefill(model, {k: v[rows] for k, v in inputs.items()},
                             key)
    model.cfg = cfg
    check(rel["dropped"] == 0, f"{tag}: decode vs prefill dropped "
          f"{rel['dropped']} assignments")
    emit({"phase": tag, "step": "decode_vs_prefill", **rel,
          "capacity_factor": model.cfg.moe.capacity_factor if moe else None,
          "checked": False})

    if cfg.frontend != "embeddings":
        emit({"phase": tag, "step": "serve", **_serve_drain(model, tag)})
        gc.collect()   # the drain's timing hook held a cycle to the model

    # last, so that no timing above runs after the profiler has run
    want = {}
    if n_attn:
        want[FA_KERNELS["wgmma"][1]] = n_attn
    if n_rglru:
        want["rglru_scan_kernel"] = n_rglru
    prof = _profile_step(lambda: model.prefill(inputs), tag, want)
    emit({"phase": tag, "step": "profile_prefill", **prof})
    cache = model.init_cache(SERVE["slots"], SERVE["max_seq"])
    one = _family_inputs(cfg, g, dev, SERVE["slots"], 1) if key == \
        "frames" else {"tokens": torch.randint(
            1, cfg.vocab_size, (SERVE["slots"], 1), generator=g, device=dev,
            dtype=torch.int32)}
    prof = _profile_step(lambda: model.decode_step(one, cache), tag, {})
    emit({"phase": tag, "step": "profile_decode_step", **prof})
    del model, cache, inputs, logits
    gc.collect()
    torch.cuda.empty_cache()
    phase_f32_relations(dev, tag, full)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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

    at_path, at_lm = phase_kernels(dev)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        launches, raw, scan_ref = phase_scan(dev, tmp)
        launches["harmonize"] = phase_harmonize(raw)
        fused_run = phase_fused(dev, tmp)
        _, fused_ref = phase_fused_decide(dev, tmp, scan_ref)
        refs = {"scan": scan_ref, "scan_fused_decide": fused_ref}
        phase_async(dev, tmp, refs)
        phase_loop_order(dev, tmp, refs)
        phase_sharded(dev, tmp, raw, refs)
        phase_autotune(dev, tmp)
        dense_profile = fused_ref["profile"]
        del scan_ref, fused_ref, refs
        phase_online_train(dev, tmp)
        phase_elastic(dev, tmp, dense_profile)
        phase_modular(dev, tmp, fused_run)
        del fused_run
    del raw
    # launches per path: the decision loop's kernels (harmonize: its op
    # entry point), then each LM's prefill
    by_path = {name: ({"harmonize_op": n} if name == "harmonize" else
                      {"decision_loop": n}) for name, n in launches.items()}
    by_path["flash_attention"] = {f"lm_{LM_ARCH}": phase_lm(dev)}
    for arch in FAMILIES:
        for name, n in phase_lm_family(dev, arch).items():
            if n:
                by_path[name][f"lm_{arch}"] = n

    def entry(name):
        t = at_path[name]
        us = {f"{k[:-3]}_us": (None if t[k] is None else t[k] * 1e3)
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        us["us"] = us.pop("_us")
        extra = {"at_lm_shape": at_lm[name]} if name in at_lm else {}
        return dict(name=name, route="cuda", parity="ok",
                    source=KERNEL_META[name][0],
                    replaces=KERNEL_META[name][1],
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name], **t, **us, **extra)

    emit({"kernels": [entry(name) for name in KERNEL_META]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
