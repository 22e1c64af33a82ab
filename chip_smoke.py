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
  6. harmonize_system — the harmonize op entry point on the K windows of
     one batch the scan system assembled, held against its plain version
     and against ``core.harmonize.harmonize_segment(agg="mean")``, and bit
     for bit against a sequential float32 loop; its instance (``warp``)
     from ``LAUNCHES_BY_IMPL`` and the profiler's trace, and the batch's
     device time.
  7. lm      — the LM side-car's serving path at qwen3-0.6b's full width
     (28 layers, d_model 1024, vocab 151936, bfloat16, seeded random
     weights): ``LM.prefill`` on 4 x 2048 tokens with one flash-attention
     launch per layer counted, decode against prefill, and a
     ``ServeEngine`` run at ``launch/serve.py``'s defaults.
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
BF16_OPS_PER_S = 989e12         # H100 SXM bfloat16 tensor cores, dense
E, K, BATCHES, CAPACITY = 256, 32, 4, 4096
N_TICKS, TICK_S, MAX_SAMPLES, HIDDEN = 8, 60.0, 32, 16
# the LM side-car: prefill batch and prompt length, the decode-vs-prefill
# tail, and launch/serve.py's defaults
LM_ARCH, LM_B, LM_S, LM_TAIL = "qwen3-0.6b", 4, 2048, 8
SERVE = dict(slots=4, max_seq=128, requests=8, prompt_len=8, new_tokens=16)
# decode against prefill in bfloat16 over 28 layers: the two sides round
# at other places (the flash kernel keeps p in float32, decode rounds it to
# bfloat16; the products differ in shape and order), and the logits
# themselves are rounded to bfloat16 (an ulp is 2^-5 at |logit| in [4, 8)).
# Bound: 0.25, eight such ulps; see PERF.md
LM_DECODE_BOUND = 0.25


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(obj):
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


def device_ms(fn, reps=20, warmup=3, tries=3):
    """Device time of one call: the card's busy time (every kernel the call
    launched, gaps between them excluded), from the profiler's CUPTI trace,
    averaged over ``reps`` calls. A trace now and then holds no device
    activity at all; then it is taken again, up to ``tries`` times, and
    None is returned if every one came back empty (the caller then reports
    event times)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = _device_us(prof.key_averages())
        if total > 0:
            return total / reps / 1e3
    return None


def traced_kernels(fn, reps=10, tries=3):
    """Names of the device kernels that ``reps`` calls of ``fn`` ran, from
    the profiler's trace (not from the wrappers' counters). A trace of a
    single call came back empty on the card; an empty trace is taken
    again, as in ``device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = []
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA})
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
    ran = [n for n in traced_kernels(call) if name in n]
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
FA_KERNELS = {
    "wgmma": ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_sm90.cu", "flash_attention_sm90_kernel"),
    "scalar": ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu", "flash_attention_kernel"),
}


def flash_cases(dev, g):
    """qwen3-0.6b's prefill attention (B=4, 16 q / 8 kv heads, head dim
    128, S=2048) in bfloat16 and float32, a ragged S, a window and a
    softcap; and gemma2-2b's (8 q / 4 kv heads, head dim 256, its 4096
    window and attention cap of 50). Each case names the kernel it must
    run (``ops.impl_for``), checked through ``LAUNCHES_BY_IMPL`` and the
    kernel names in a profiler trace. Tolerances: float32 max abs err
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
             "wgmma")):
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
        if not window and not softcap:
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
    at_path = {}
    for case in kernel_cases(dev, g):
        err = case["compare"]()
        long_ = case["shape"] == "sequence" or case["name"] == \
            "flash_attention"
        reps = 20 if long_ else 50
        calls = {k: call_ms(case[k], reps=reps) for k in
                 ("kernel", "plain", "library") if case[k] is not None}
        dev_ms = {k: device_ms(case[k]) for k in calls}
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


def drive_loop(system, label, spans):
    """The decision loop's main path: ``K * BATCHES`` windows through
    ``system.run_windows``, timed, with every kernel count set to 0 just
    before and read just after. Checks locf n, window_agg 2n and rglru_scan
    n launches, all locf and window_agg launches on the ``row`` instance.
    Then one more batch, untimed, under ``count_fetches`` for the bytes
    fetched to the host (the patched ``Tensor`` methods stay out of the
    timed run). Returns the run's reading: every window's result (timed and
    counted batches), windows/s, launches, and per batch the ms of each
    interval list in ``spans`` (timed batches only), the pump and assembly
    time that overlapped the Manager's, and the host bytes."""
    from repro_torch.kernels.locf import ops as locf_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.window_agg import ops as wagg_ops

    n = K * BATCHES
    locf_ops.LAUNCHES = wagg_ops.LAUNCHES = rglru_ops.LAUNCHES = 0
    for ops in (locf_ops, wagg_ops):
        ops.LAUNCHES_BY_IMPL.update(row=0, warp=0)
    for v in spans.values():
        v.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = system.run_windows(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"locf": locf_ops.LAUNCHES, "window_agg": wagg_ops.LAUNCHES,
                "rglru_scan": rglru_ops.LAUNCHES}
    by_impl = {"locf": dict(locf_ops.LAUNCHES_BY_IMPL),
               "window_agg": dict(wagg_ops.LAUNCHES_BY_IMPL)}
    ms = {f"{k}_ms_per_batch": sum(b - a for a, b in v) * 1e3 / BATCHES
          for k, v in spans.items()}
    ms["pump_overlapping_manager_ms_per_batch"] = _overlap_s(
        spans["pump"] + spans["assemble"], spans["manager"]) * 1e3 / BATCHES
    check(len(results) == n,
          f"{label}: {len(results)} results, expected {n}")
    check(launches == {"locf": n, "window_agg": 2 * n, "rglru_scan": n},
          f"{label}: kernel launches {launches}, expected locf {n}, "
          f"window_agg {2 * n}, rglru_scan {n}")
    check(by_impl == {"locf": {"row": n, "warp": 0},
                      "window_agg": {"row": 2 * n, "warp": 0}},
          f"{label}: launches by instance {by_impl}, expected every locf "
          f"and window_agg launch on the row instance")
    with count_fetches() as fetched:
        results = results + system.run_windows(K)
        torch.cuda.synchronize()
    return {"results": results, "windows_per_s": n / wall, "wall_s": wall,
            "launches": launches, "launches_by_impl": by_impl, **ms,
            "host_bytes_per_batch": fetched.bytes}


def loop_record(system, run):
    """What a run of the decision loop left behind, for the bit-for-bit
    comparison of two modes over the same windows."""
    return {"results": [{k: v for k, v in r.items() if k != "latency_s"}
                        for r in run["results"]],
            "export": system.export_replay("salt"),
            "db_rows": _db_rows(system),
            "sinks": [list(f.sink) for f in system.forwarders.forwarders],
            **{k: v for k, v in run.items() if k != "results"}}


def run_mode(mode, dev, tmp, tag=""):
    """A fresh ``mode`` system driven by ``drive_loop`` with the same
    instrument as every other mode; returns it and its record."""
    system = make_system(mode, dev, str(Path(tmp) / f"{mode}{tag}"))
    spans = instrument(system)
    run = drive_loop(system, mode + tag, spans)
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
    Emits and returns the reading."""
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
    for s in (fused, scan):
        s.db.close()
        s.stop()


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
    prof = profile_batch(system, "fused_decide_profile")
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


def phase_loop_order(dev, tmp, first):
    """The four batch modes again, fresh systems over the same windows, in
    the reverse of the order the phases above ran them, each checked bit for
    bit against its twin's first run. A mode's windows/s is then read once
    early and once late in the process (host time of identical work drifts
    within one run), and the mean of its two readings is what compares
    modes."""
    order = list(LOOP_TWIN)
    out = {"phase": "loop_order", "order": [order, order[::-1]]}
    for mode in order[::-1]:
        system, got = run_mode(mode, dev, tmp, tag="_late")
        check_same_loop(f"{mode} (late) != {LOOP_TWIN[mode]}", got,
                        first[LOOP_TWIN[mode]])
        system.db.close()
        system.stop()
        for key in ("windows_per_s", "pump_ms_per_batch",
                    "assemble_ms_per_batch", "manager_ms_per_batch"):
            pair = [first[mode][key], got[key]]
            out.setdefault(key, {})[mode] = pair + [sum(pair) / 2]
    emit(out)


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
    traced = [n for n in traced_kernels(lambda: window(0))
              if "harmonize" in n]
    check(len(traced) == 1 and f"harmonize_{impl}_kernel" in traced[0],
          f"harmonize: trace shows {traced}, expected harmonize_{impl}_kernel")
    batch_ms = device_ms(lambda: [window(j) for j in range(k)], reps=5)
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


def phase_lm(dev):
    """qwen3-0.6b at full width: prefill, decode against prefill, and the
    serving engine. Returns the flash-attention launches of one prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import LM
    from repro_torch.serve.engine import Request, ServeEngine

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
          "serve: a request did not complete")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "serve: token out of range")
    check(engine.stats["admitted"] == engine.stats["retired"] ==
          SERVE["requests"] and engine.stats["timeouts"] == 0,
          f"serve: stats {engine.stats}")
    emit({"phase": "lm_serve", **SERVE, "completed": len(reqs),
          "tokens": n_tok, "wall_s": wall_ms / 1e3,
          "tokens_per_s": n_tok / (wall_ms / 1e3),
          "engine_ticks": engine.stats["ticks"],
          "decode_steps": len(steps),
          "ms_per_decode_step": statistics.median(steps),
          "stats": engine.stats})
    del engine

    # last, so that no timing above runs after a profiler session: where
    # one prefill's and one serving decode step's device time goes
    cache = model.init_cache(SERVE["slots"], SERVE["max_seq"])
    tok = torch.ones((SERVE["slots"], 1), dtype=torch.int32, device=dev)
    for name, fn in (("prefill", lambda: model.prefill({"tokens": toks})),
                     ("decode_step", lambda: model.decode_step(
                         {"tokens": tok}, cache))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _sync_ms(fn)
        devs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        top = sorted(devs, key=lambda e: -e.self_device_time_total)[:6]
        busy = _device_us(devs) / 1e3
        fa_names = [e.key for e in devs if "flash_attention" in e.key]
        if name == "prefill":
            check(len(fa_names) == 1 and FA_KERNELS["wgmma"][1] in
                  fa_names[0] and sum(e.count for e in devs if e.key in
                                      fa_names) == cfg.n_layers,
                  f"lm: the prefill trace shows flash kernels {fa_names}, "
                  f"expected {cfg.n_layers} launches of the wgmma kernel")
        emit({"phase": f"lm_profile_{name}", "wall_ms": wall,
              "flash_attention_kernels": fa_names,
              "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
              "device_kernels": sum(e.count for e in devs),
              "flash_attention_device_ms": sum(
                  e.self_device_time_total for e in devs
                  if "flash_attention" in e.key) / 1e3,
              "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                for e in top}})
    del model, cache
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

    at_path = phase_kernels(dev)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        launches, raw, scan_ref = phase_scan(dev, tmp)
        phase_fused(dev, tmp)
        _, fused_ref = phase_fused_decide(dev, tmp, scan_ref)
        refs = {"scan": scan_ref, "scan_fused_decide": fused_ref}
        phase_async(dev, tmp, refs)
        phase_loop_order(dev, tmp, refs)
        del scan_ref, fused_ref, refs
    launches["harmonize"] = phase_harmonize(raw)
    del raw
    launches["flash_attention"] = phase_lm(dev)

    def entry(name):
        t = at_path[name]
        us = {f"{k[:-3]}_us": (None if t[k] is None else t[k] * 1e3)
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        us["us"] = us.pop("_us")
        return dict(name=name, route="cuda", parity="ok",
                    source=KERNEL_META[name][0],
                    replaces=KERNEL_META[name][1], launches=launches[name],
                    **t, **us)

    emit({"kernels": [entry(name) for name in KERNEL_META]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
