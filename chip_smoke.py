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
     Kernels with instances (flash_attention: ``wgmma`` for bfloat16 and
     float16 at head dims that are multiples of 8 up to 256, ``scalar``
     otherwise; locf and
     window_agg: ``row`` at T <= 16, ``warp`` above; harmonize: ``warp``
     up to ``MAX_T`` ticks, ``tiled`` above) name the instance each case
     ran, from the launch counts and the profiler's trace. flash_attention
     also runs in float16 (``path_f16``), at head dims off the instances'
     widths (``d48``, ``d80``, ``d96`` wgmma; ``d320``, ``d36`` scalar)
     and at query offsets
     (``ctx_shard*``, context parallelism's shard shapes, each counted in
     ``LAUNCHES_BY_OFFSET`` under its instance and offset); harmonize
     over a week of 30 s ticks (``long``, T = 20,160). The flash
     gradient (``flash_attention_bwd``: four launches, delta, dK/dV, their
     sum over a kv head's q heads, dQ; its ``wgmma`` instance on the
     tensor cores for bfloat16 and float16 at head dims that are
     multiples of 8 up to 256, ``tf32`` (three TF32 products a product,
     after a split pass that also computes delta) for the rest up to 128,
     ``fma`` above, named by ``ops.bwd_impl_for``) at qwen3-0.6b's
     training microbatch (``path``) and recurrentgemma-2b's
     (``train_rg``), wgmma, at qwen3's heads in float32 (``path_f32``)
     and at D 36 in bfloat16 (``d36``), tf32, and at recurrentgemma-2b's
     heads in float32 (``rg_f32``, D 256), FMA, against the chunked plain
     backward from the same forward, its library yardstick autograd's
     backward of ``scaled_dot_product_attention``.
  4. scan    — the port's PerceptaSystem in ``scan`` mode at E=256 envs,
     S=8 sources, K=32 windows per batch, replay capacity 4096, the rglru
     policy: 3 batches (96 windows) timed, with every kernel launch
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
     a checkpoint every applied step), 3 batches a run, fresh systems
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
  6a. harmonize_week — the op entry point once over a week of 30 s
     ticks (HZ_WEEK), its launch counted on the ``tiled`` instance.
  7. lm      — the LM side-car's serving path at qwen3-0.6b's full width
     (28 layers, d_model 1024, vocab 151936, bfloat16, seeded random
     weights): ``LM.prefill`` on 4 x 2048 tokens with one flash-attention
     launch per layer counted, decode against prefill, and a
     ``ServeEngine`` drain at ``SERVE`` (``launch/serve.py``'s slots and
     max_seq, fewer and shorter requests).
  7a. lm_float16 — the same model in float16 (``phase_lm_float16``):
     prefill with its 28 flash launches on the wgmma kernel's float16
     instance (named in a trace), decode against prefill (reported), a
     ``ServeEngine`` drain, and a float32 twin with the same weights (its
     launches on the scalar instance) held to LM_F16_TWIN_BOUND.
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
  9. lm_train — qwen3-0.6b training at full width (``phase_lm_train``):
     train_4k's sequence of 4096 at a global batch of 4 (cut from 256 for
     one card) in 2 microbatches, full remat, seeded bfloat16 weights and
     AdamW from zeros, one synthetic batch repeated. ``FlashAttentionFn``
     (the kernel forward with its logsumexp, the gradient kernels'
     backward) against autograd through ``attention_ref`` at the
     microbatch's shape within ``ref.backward_error_bound``; the step's
     flash launches (28 a microbatch, twice under the remat) and gradient
     launches (28 a microbatch of each of its wgmma instance's four
     kernels), named in a trace; two steps from one state bit for bit;
     the loss falling over 5 steps; a profiled step. Step ms, tokens/s,
     idle share, peak memory (beside the step's before the gradient
     kernel) and the model-FLOP share
     of the bf16 peak. Before it, ``flash_bwd_32k``: the gradient kernels
     at qwen3's heads and a 32,768-token context (batch 1, bfloat16),
     under 1 GiB above their inputs, timed, against the chunked plain
     backward.
 10. lm_train_rglru — recurrentgemma-2b training at full width, 2 x 2048
     (``phase_lm_train_rglru``): ``RGLRUScanFn`` (the kernel forward, one
     reversed kernel scan backward) against autograd through the plain
     loop at the step's shape; the step's rglru_scan and flash launches;
     two steps from one state compared by digest; the loss falling on the
     next step; a profiled step.
 11. lm_sharded — the LM on meshes of logical shards of the card
     (``phase_lm_sharded``, the comment above ``SHARD_QWEN``).
 12. lm_sharded_more — the rest of model sharding on logical shards of
     the card (``phase_lm_sharded_more``, the comment above
     ``SHARD_MORE_RG``): context-parallel attention (its flash launches
     at query offsets, each counted and traced), heads that do not
     divide, ``seq_parallel``, RWKV-6 and the ``embeddings``/``vlm``
     frontends, each beside its unsharded twin.
  Phase 8 runs in a child process of the script (``--families``), and
  phases 9 to 12 in another (``--train``); the script waits for each
  (see ``in_child``). Phases 11 and 12's train steps run the gradient
  kernels too (qwen3's sharded step checks the wgmma instance's launches,
  its float32 twin's step the tf32 instance's, recurrentgemma-2b's float32
  twin in phase 12 the FMA instance's).
The line before the last holds one JSON object with every kernel's
numbers (``launches`` summed over the paths and instances,
``launches_by_path`` each path's, ``at_lm_shape`` the times at the LM
prefill shape; the flash gradient's ``flash_attention_bwd`` entry at
qwen3's training microbatch, with ``at_train_rg`` and the reference
gradient it replaces), then one entry per instance that this script counts on a
path of its own (INSTANCE_ENTRIES: flash_attention's float16 wgmma and
its scalar instance, the gradient's tf32 and FMA instances, harmonize's
tiled); the
last line
is ``{"ok": true, "device": {...}}``. Without a
card the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# BATCHES timed batches a mode: 3, so that online_train applies a step on
# top of another (the decision loop's phases are host-bound: each batch a
# mode costs ~7 s on a slow host, see SERVE for the room made for it)
E, K, BATCHES, CAPACITY = 256, 32, 3, 4096
N_TICKS, TICK_S, MAX_SAMPLES, HIDDEN = 8, 60.0, 32, 16
# the LM side-car: prefill batch and prompt length, the decode-vs-prefill
# tail, and launch/serve.py's slots and max_seq but for its requests, whose
# default is 8 prompts of 8 tokens asking for 16, two waves of the 4 slots.
# The engines' depth is cut to make room for the decision loop's third
# batch (seven drains took ~54 s of the script at 8 requests and ~54 s
# again at 5 of 8 + 16 tokens, 51 engine steps each, on a slow host): 5
# requests of 4 prompt tokens (3 prefill steps an admission), the first
# asking for `refill_at` tokens and the last for the rest of 8, so that
# the last is admitted into the first's freed slot (lengths reset, the
# slot's cache rows overwritten) and every slot ends at tick 8, one wave's
# ticks: 23 engine steps a drain
LM_ARCH, LM_B, LM_S, LM_TAIL = "qwen3-0.6b", 4, 2048, 8
SERVE = dict(slots=4, max_seq=128, requests=5, prompt_len=4, new_tokens=8,
             refill_at=2)
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


# idle host time inside each profiler trace on both sides of the traced
# work: the profiler keeps only the device records whose timestamps fall
# inside its window on the host's clock, and a drift between the card's
# clock and the host's is the likely cause of the traces that lost the
# first kernels of a call, the same ones in every retry, late in a long
# process (PERF.md §7). ``device_window_ms`` reports where the work fell.
TRACE_PAD_S = 0.03


@contextlib.contextmanager
def _trace(cpu=False):
    """A profiler trace of the block (device activity, and the host's too
    if ``cpu``), the card drained before it and TRACE_PAD_S of idle time
    inside the window on each side of the block."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def device_window_ms(prof):
    """The first device record's start and the last one's end, in ms from
    the trace's start on the host's clock ([None, None] if it has none):
    about TRACE_PAD_S and the window's length less it where the clocks
    agree."""
    from torch.autograd import DeviceType
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        return [None, None]
    return [min(a for a, _ in spans) / 1e3, max(b for _, b in spans) / 1e3]


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


def _records(events, want):
    """The device records among ``events`` of kernels whose names contain
    a name in ``want``, per kernel name: {name: (count, summed us)}."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, _device_us([e])) for e in events
            if e.device_type == DeviceType.CUDA
            and any(w in e.key for w in want)}


def device_ms(fn, reps=20, warmup=3, tries=3, want=(), info=None):
    """Device time of one call: the card's busy time (every kernel the call
    launched, gaps between them excluded), from the profiler's CUPTI trace,
    averaged over ``reps`` calls. A trace now and then holds no device
    activity at all, or loses the kernels launched through the ctypes
    library (PERF.md §7); then it is taken again, up to ``tries`` times.
    If every trace came back empty, None is returned (the caller then
    reports event times); if every one lacks a kernel named in ``want``,
    the check fails rather than read low. The kernels in ``want`` are
    timed by the mean of the records the trace holds: in this script's
    process a trace of 20 calls kept 17 or 18 of their records, the same
    share for every kernel and shape (PERF.md §7), which divided by the
    20 calls read every kernel 10-15% low; each named kernel is averaged
    on its own (a call may launch several of unequal length). ``info``
    gets the records held and the records the calls made (``reps`` times
    the launches a call, per kernel the nearest whole number to its
    records over ``reps``)."""
    for _ in range(warmup):
        fn()
    missing = []
    for _ in range(tries):
        with _trace() as prof:
            for _ in range(reps):
                fn()
        events = prof.key_averages()
        total = _device_us(events)
        missing = _missing(events, want)
        if total > 0 and not missing:
            if not want:
                return total / reps / 1e3
            # each named kernel: the mean of its records held times its
            # launches a call (a call of the flash gradient launches three
            # or four kernels of unequal length)
            recs = _records(events, want)
            per_call = {k: max(1, round(n / reps)) for k, (n, _) in
                        recs.items()}
            wanted_us = sum(us for _, us in recs.values())
            if info is not None:
                info.update(trace_records=sum(n for n, _ in recs.values()),
                            trace_records_made=sum(per_call.values()) * reps)
            return (sum(us / n * per_call[k] for k, (n, us) in recs.items())
                    + (total - wanted_us) / reps) / 1e3
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
    marker = torch.zeros((), device="cuda")
    names = []
    fn()
    for _ in range(tries):
        with _trace() as prof:
            for _ in range(reps):
                fn()
            marker.fill_(1.0)
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and want in e.key})
        if names:
            break
    return names


def bound(bytes_moved, ops, ops_rate=None):
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate of their type (float32 outside
    the tensor cores by default), the peaks ``launch.roofline``'s."""
    from repro_torch.launch import roofline
    t_bytes = bytes_moved / roofline.HBM_BYTES_PER_S * 1e3
    t_ops = ops / (ops_rate or roofline.F32_FLOPS) * 1e3
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


def kernel_cases(dev, g, bwd_specs=None):
    """(name, shape label, kernel call, plain call, compare, bytes, ops,
    library call or None) at the path's shapes and a fleet shape; the
    flash gradient's cases last, at ``bwd_specs`` (default
    FLASH_BWD_SPECS; empty for a tree before the gradient kernel, which
    has none to build them with)."""
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
    # the cases added since: after every earlier case, so that those keep
    # the generator's draws they had
    return (cases + harmonize_cases(dev, g, HZ_CASES) + flash_cases(dev, g)
            + harmonize_cases(dev, g, HZ_DOMAIN_CASES)
            + flash_specs(dev, g, FLASH_DOMAIN_SPECS)
            + flash_bwd_cases(dev, g, FLASH_BWD_SPECS if bwd_specs is None
                              else bwd_specs))


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


# harmonize's tiled instance (T above ops.MAX_T): a week of 30 s ticks for
# 64 buildings of 8 sensors, 2048 samples a stream (phase 3's ``long``
# case and the op's week path in phase 6); the plain version holds (R, M,
# T) at once, so it runs on the first HZ_PLAIN_ROWS rows only, and the
# sequential loop checks every row
HZ_WEEK = dict(e=64, s=8, m=2048, t=20_160, tick=30.0)
HZ_PLAIN_ROWS = 8


def _hz_samples(g, dev, e, s, m, t, tick):
    """Samples of (e, s, m) rows with timestamps from half a tick before 0
    to one tick after t ticks, 80% valid, and window starts within half a
    tick of 0."""
    ts = (torch.rand((e, s, m), generator=g, device=dev) * (t + 1.5)
          - 0.5) * tick
    v = torch.randn((e, s, m), generator=g, device=dev)
    ok = torch.rand((e, s, m), generator=g, device=dev) < 0.8
    ws = (torch.rand((e,), generator=g, device=dev) - 0.5) * tick
    return v, ts, ok, ws


# label, (E, S, M, T, tick_s), the instance: the decision loop's window,
# a fleet window (4096 envs x 8 streams, 128 samples into 64 ticks), and
# a week of 30 s ticks (HZ_WEEK, T = 20,160)
HZ_CASES = (("path", (E, 8, MAX_SAMPLES, N_TICKS, TICK_S), "warp"),
            ("fleet", (4096, 8, 128, 64, TICK_S), "warp"))
HZ_DOMAIN_CASES = (("long", tuple(HZ_WEEK[k] for k in
                                  ("e", "s", "m", "t", "tick")), "tiled"),)


def harmonize_cases(dev, g, specs):
    """The harmonize kernel at ``specs`` (HZ_CASES, HZ_DOMAIN_CASES): the
    ``warp`` instance up to MAX_T ticks, ``tiled`` above, each with staged
    float4 loads (``impl_for``), checked through ``LAUNCHES_BY_IMPL`` and
    the profiler's kernel name; the means must equal a sequential float32
    loop bit for bit."""
    from repro_torch.kernels.harmonize import ops as hz_ops
    from repro_torch.kernels.harmonize.ref import harmonize_ref

    cases = []
    for label, (e, s, m, t, tick), impl_want in specs:
        R = e * s
        v, ts, ok, ws = _hz_samples(g, dev, e, s, m, t, tick)
        rows = R if impl_want == "warp" else HZ_PLAIN_ROWS

        def plain(v=v, ts=ts, ok=ok, ws=ws, R=R, m=m, t=t, s=s, rows=rows,
                  tick=tick):
            return harmonize_ref(v.reshape(R, m)[:rows],
                                 ts.reshape(R, m)[:rows],
                                 ok.reshape(R, m)[:rows],
                                 ws.repeat_interleave(s)[:rows], tick, t)

        def kernel(v=v, ts=ts, ok=ok, ws=ws, t=t, tick=tick):
            return hz_ops.harmonize(v, ts, ok, ws, tick_s=tick, n_ticks=t)

        info = {}

        def cmp(kernel=kernel, plain=plain, R=R, m=m, t=t, label=label,
                info=info, args=(v, ts, ok, ws, s), rows=rows, tick=tick,
                impl_want=impl_want):
            from repro_torch.kernels.rows import aligned
            impl, vec = hz_ops.impl_for(m, aligned(*args[:3]), t)
            check((impl, vec) == (impl_want, True),
                  f"harmonize {label}: impl_for gives {(impl, vec)}")
            out, obs = check_instance(hz_ops, "harmonize", label, kernel,
                                      impl, info)
            ref, ref_obs = plain()
            out, obs = out.reshape(R, t), obs.reshape(R, t)
            check(torch.equal(obs[:rows], ref_obs),
                  "harmonize: observed differs")
            torch.testing.assert_close(out[:rows], ref, rtol=1e-4,
                                       atol=1e-5)
            v, ts, ok, ws, s = args
            seq, seq_obs = sequential_harmonize(
                v.reshape(R, m), ts.reshape(R, m), ok.reshape(R, m),
                ws.repeat_interleave(s), tick, t)
            check(torch.equal(obs, seq_obs) and bits_equal(out, seq),
                  f"harmonize {label}: differs from the sequential loop")
            info.update(vec=vec, bit_equal_sequential=True, plain_rows=rows,
                        observed_frac=obs.float().mean().item())
            return (out[:rows] - ref).abs().max().item()

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
              "flash_attention": "flash_attention",
              "flash_attention_bwd": "flash_bwd"}
# the loop's kernels in a traced batch
LOOP_TRACE = ("locf", "window_agg", "rglru")

FA_KERNELS = {
    "wgmma": ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_sm90.cu", "flash_attention_sm90_kernel"),
    "scalar": ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu", "flash_attention_kernel"),
}
# the gradient's sources by instance (its dK/dV and dQ kernels, and the
# tf32 instance's split pass; every instance launches the FMA source's sum
# kernel, the wgmma and FMA instances its delta kernel) and its device
# kernels (delta, each q head's share of dK/dV, their sum over a kv head's
# q heads, dQ), by the name its wrapper counts them under
# (ops.LAUNCHES_BWD_BY_KERNEL; ops.BWD_KERNELS names each instance's four)
FA_BWD_SOURCES = {
    "wgmma": ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd_sm90.cu"),
    "tf32": ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_bwd_tf32.cu"),
    "fma": ("src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu")}
FA_BWD_KERNELS = {"dot": "flash_bwd_dot_kernel",
                  "dkdv": "flash_bwd_dkdv_kernel",
                  "dq": "flash_bwd_dq_kernel",
                  "dkdv_sum": "flash_bwd_dkdv_sum_kernel",
                  "dkdv_wgmma": "flash_bwd_dkdv_wgmma_kernel",
                  "dq_wgmma": "flash_bwd_dq_wgmma_kernel",
                  "split_tf32": "flash_bwd_split_tf32_kernel",
                  "dkdv_tf32": "flash_bwd_dkdv_tf32_kernel",
                  "dq_tf32": "flash_bwd_dq_tf32_kernel"}


def _flash_bound_check(label, out, ref, dtype, info):
    """Hold a flash output to its bound against ``attention_ref``: in a
    16-bit type |out - ref| <= u |ref| + 1e-5 (u = 2^-7 in bfloat16, one
    ulp; 2^-9 in float16, two ulps: FLASH_ULP); in float32 max abs err
    2e-3.
    Records the ratio to the bound in ``info``; returns the max abs err."""
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    if dtype in FLASH_ULP:
        ulp = FLASH_ULP[dtype]
        ratio = (diff / (ulp * ref.abs() + 1e-5)).max().item()
        info.update(tol=f"{ulp} |ref| + 1e-5", err_over_tol=ratio)
        check(ratio <= 1.0, f"flash_attention {label}: error {ratio} x the "
              f"bound (max abs {err})")
    else:
        info.update(tol=2e-3, err_over_tol=err / 2e-3)
        check(err <= 2e-3, f"flash_attention {label}: max abs err {err} > "
              "2e-3")
    return err


# the flash kernels' bound in each 16-bit type, relative to the plain
# output: one bfloat16 ulp; two float16 ulps, since the kernel's and the
# plain version's float32 tanh and exp differ in their last bits, which at
# softcapped scores in the tens moves an output by ~1e-5 relative, one
# float16 rounding step (tests/test_torch_card.py)
FLASH_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9}


# label, dtype, S, window, softcap, (H, Hkv, D), the instance (phase 3)
FLASH_SPECS = (
    ("path", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 128), "wgmma"),
    ("path_f32", torch.float32, LM_S, 0, 0.0, (16, 8, 128), "scalar"),
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
     (10, 1, 256), "wgmma"))
# the reference's whole input domain: float16 at qwen3's prefill shape,
# and head dims off the instances' widths: 48, 80 and 96 on the wgmma
# kernel's 64- and 128-column instances (TMA zero-fills the columns past
# D), 320 (above 256) and 36 (not a multiple of 8) on the scalar one
FLASH_DOMAIN_SPECS = (
    ("path_f16", torch.float16, LM_S, 0, 0.0, (16, 8, 128), "wgmma"),
    ("d48", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 48), "wgmma"),
    ("d80", torch.float16, LM_S, 0, 0.0, (16, 8, 80), "wgmma"),
    ("d96", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 96), "wgmma"),
    ("d320", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 320), "scalar"),
    ("d36", torch.bfloat16, LM_S, 0, 0.0, (16, 8, 36), "scalar"))


def _attention_f64(q, k, v, window, softcap):
    """The plain version's function in float64 from the same inputs: the
    truth both the kernel and the plain version round towards."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.double().reshape(
        B, S, Hkv, H // Hkv, D) / float(np.sqrt(D)), k.double())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = (i >= j) & ((i - j < window) if window else True)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    del s
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.double())
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def flash_specs(dev, g, specs):
    """The cases of ``specs`` at batch LM_B (``flash_cases``' tolerances).
    Each 16-bit case also reports how far the kernel and the plain version
    each sit from a float64 truth, in units of the bound
    (``over_float64``): the plain version is float32 and not exact
    either."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import roofline

    B = LM_B
    cases = []
    for label, dtype, S, window, softcap, (H, HKV, D), impl in specs:
        q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev)
                   .to(dtype) for h in (H, HKV, HKV))
        if softcap:
            q = q * 8
        kw = dict(window=window, softcap=softcap)
        info = {}

        def cmp(q=q, k=k, v=v, kw=kw, dtype=dtype, label=label, info=info,
                impl=impl):
            D = q.shape[-1]
            check(fa_ops.impl_for(dtype, D) == impl,
                  f"flash_attention {label}: impl_for gives "
                  f"{fa_ops.impl_for(dtype, D)}, expected {impl}")
            out = check_instance(
                fa_ops, "flash_attention", label,
                lambda: fa_ops.flash_attention(q, k, v, **kw), impl, info,
                want=FA_KERNELS[impl][1])
            ref = attention_ref(q, k, v, **kw).float()
            check(out.dtype == q.dtype, f"flash_attention {label}: dtype")
            err = _flash_bound_check(label, out, ref, dtype, info)
            info["ref_mean_abs"] = ref.abs().mean().item()
            if dtype in FLASH_ULP:
                truth = _attention_f64(q, k, v, **kw)
                tol = FLASH_ULP[dtype] * truth.abs() + 1e-5
                info["over_float64"] = {
                    name: ((x.double() - truth).abs() / tol).max().item()
                    for name, x in (("kernel", out), ("plain", ref))}
                del truth, tol
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
            ops_rate=(roofline.BF16_FLOPS if dtype in FLASH_ULP
                      else roofline.F32_FLOPS),
            library=lib))
    return cases


def flash_cases(dev, g):
    """qwen3-0.6b's prefill attention (B=4, 16 q / 8 kv heads, head dim
    128, S=2048) in bfloat16, float16 and float32, a ragged S, a window
    and a softcap; the same shape at head dims 48, 80, 96, 320 and 36,
    off the instances' widths (FLASH_DOMAIN_SPECS); gemma2-2b's (8 q / 4
    kv heads, head
    dim 256, its 4096 window and attention cap of 50); and
    recurrentgemma-2b's (10 q heads over 1 kv head, head dim 256, window
    2048). Each case names the
    kernel it must run (``ops.impl_for``), checked through
    ``LAUNCHES_BY_IMPL`` and the kernel names in a profiler trace.
    Tolerances (``_flash_bound_check``): float32 max abs err 2e-3
    (tests/test_kernels.py); bfloat16 one ulp of the plain output per
    element, float16 two (FLASH_ULP), since both compute in float32 and
    round the output once (late rows attend to ~2048 keys and their
    outputs are ~0.04, so an absolute bound would have to be far smaller
    than 5e-2 to see a dropped tile). The softcap case scales q by 8 so
    that scores reach tens and the cap of 50 (gemma2's) changes the
    output; the script checks that it does."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import roofline

    cases = flash_specs(dev, g, FLASH_SPECS)

    # context parallelism's launches (phase lm_sharded_more): one data
    # shard's rows of recurrentgemma-2b's 2 x 2048 prefill on (2, 4), the
    # first and the last model shard's (offsets 0 and 1536, the causal
    # work 1 : 7), and the float32 twin's last shard on the scalar
    # instance (2 x 512: 128 rows at offset 384)
    for label, dtype, S, rows, off, impl in (
            ("ctx_shard0", torch.bfloat16, LM_S, LM_S // 4, 0, "wgmma"),
            ("ctx_shard3", torch.bfloat16, LM_S, LM_S // 4, 3 * LM_S // 4,
             "wgmma"),
            ("ctx_shard3_f32", torch.float32, 512, 128, 384, "scalar")):
        H, HKV, D, window = 10, 1, 256, 2048
        q = torch.randn((1, rows, H, D), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((1, S, HKV, D), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        kw = dict(window=window, q_offset=off)
        info = {}

        def cmp(q=q, k=k, v=v, kw=kw, dtype=dtype, label=label, info=info,
                impl=impl):
            key = (impl, kw["q_offset"])
            before = fa_ops.LAUNCHES_BY_OFFSET.get(key, 0)
            out = check_instance(
                fa_ops, "flash_attention", label,
                lambda: fa_ops.flash_attention(q, k, v, **kw), impl, info,
                want=FA_KERNELS[impl][1])
            check(fa_ops.LAUNCHES_BY_OFFSET.get(key, 0) > before,
                  f"flash_attention {label}: the launch was not counted "
                  f"under {key}")
            ref = attention_ref(q, k, v, **kw).float()
            return _flash_bound_check(label, out, ref, dtype, info)

        pos = torch.arange(off, off + rows, device=dev)[:, None]
        key = torch.arange(S, device=dev)[None, :]
        mask = (key <= pos) & (pos - key < window)
        pairs = sum(min(i + 1, window) for i in range(off, off + rows))
        cases.append(dict(
            name="flash_attention", shape=label,
            dims=dict(B=1, S=rows, S_kv=S, q_offset=off, H=H, Hkv=HKV, D=D,
                      dtype=str(dtype)[6:], window=window, softcap=0.0),
            kernel=lambda q=q, k=k, v=v, kw=kw: fa_ops.flash_attention(
                q, k, v, **kw),
            plain=lambda q=q, k=k, v=v, kw=kw: attention_ref(q, k, v, **kw),
            compare=cmp, info=info,
            # read q, k, v, write out: q and out at the shard's rows, k
            # and v at the positions those rows see, max(0, off - window
            # + 1) .. off + rows - 1; 4 H D flops per scored (q, k) pair
            bytes=(2 * rows * H + 2 * (off + rows - max(0, off - window + 1))
                   * HKV) * D * q.element_size(),
            ops=4 * H * D * pairs,
            ops_rate=(roofline.BF16_FLOPS if dtype in FLASH_ULP
                      else roofline.F32_FLOPS),
            library=lambda q=q, k=k, v=v, mask=mask:
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)))
    return cases


def _bwd_ratio(got, want, bounds):
    """The largest |got - want| over its bound, over dq, dk and dv (an
    element whose bound is 0 must be exact)."""
    worst = 0.0
    for a, b, t in zip(got, want, bounds):
        err = (a.double() - b.double()).abs()
        worst = max(worst, (err / t).nan_to_num(nan=0.0, posinf=1e30)
                    .max().item())
        del err
    return worst


def bwd_expected(calls=1, impl="wgmma"):
    """The gradient's launches per kernel in ``calls`` backward calls of
    instance ``impl``: each of its four kernels once a call, the other
    instance's none."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return {k: calls if k in fa_ops.BWD_KERNELS[impl] else 0
            for k in FA_BWD_KERNELS}


def bwd_launches_check(label, before, impl="wgmma"):
    """Each of instance ``impl``'s gradient kernels launched once more than
    in ``before`` (a copy of ``ops.LAUNCHES_BWD_BY_KERNEL``), no other;
    returns their device names."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    want = {k: n + bwd_expected(1, impl)[k] for k, n in before.items()}
    check(fa_ops.LAUNCHES_BWD_BY_KERNEL == want,
          f"{label}: gradient launches {fa_ops.LAUNCHES_BWD_BY_KERNEL}, "
          f"expected {want} ({impl})")
    return [FA_BWD_KERNELS[k] for k in fa_ops.BWD_KERNELS[impl]]


# the flash gradient's cases (phase 3): label, dtype, the instance
# (ops.bwd_impl_for), (B, S, H, Hkv, D, window), q pre-scaled and scale 1
# as the model calls it; "path" is qwen3-0.6b's training microbatch
# (TRAIN: 2 x 4096), "train_rg" recurrentgemma-2b's (TRAIN_RG: 2 x 2048,
# 10 q heads over 1 kv head, head dim 256, window 2048), both bfloat16 on
# the wgmma instance; "path_f32" qwen3's heads at 1 x 2048 in float32 (a
# float32 model's, as the sharded phases' twins) and "d36" the same heads
# at D 36 in bfloat16 (off the wgmma instance's head dims), the tf32
# instance; "rg_f32" recurrentgemma-2b's heads at 1 x 2048 in float32 (D
# 256, above the tf32 instance's widest), the FMA instance
FLASH_BWD_SPECS = (
    ("path", torch.bfloat16, "wgmma", (2, 4096, 16, 8, 128, 0)),
    ("train_rg", torch.bfloat16, "wgmma", (2, 2048, 10, 1, 256, 2048)),
    ("path_f32", torch.float32, "tf32", (1, 2048, 16, 8, 128, 0)),
    ("d36", torch.bfloat16, "tf32", (1, 2048, 16, 8, 36, 0)),
    ("rg_f32", torch.float32, "fma", (1, 2048, 10, 1, 256, 2048)))
# tools/kernel_ab.py's further case: the gradient at BWD_32K (phase 3 does
# not time it; phase flash_bwd_32k drives it once)
FLASH_BWD_AB_SPECS = (("32k", torch.bfloat16, "wgmma",
                       (1, 32768, 16, 8, 128, 0)),)


def flash_bwd_cases(dev, g, specs=FLASH_BWD_SPECS):
    """The gradient at ``specs`` (the two training shapes on the wgmma
    instance, two on the tf32 one, a float32 case on the FMA one) against
    the chunked plain backward from the same forward (the kernel's out and
    lse), within ``ref.backward_error_bound(same_stats=True)`` (the
    derived float32 bound of two orders of the same sums, plus one 16-bit
    rounding each; the instance's ``split``, ``ops.BWD_SPLIT``: True for
    the wgmma instance, whose P and dS enter its products as hi and lo
    halves of the input type, "tf32" for the tf32 instance, whose every
    operand enters as TF32 big and small halves), the instance
    ``ops.bwd_impl_for`` names, each of its four kernels launched once a
    call and named in a trace, two calls bit for bit. The bound: 2.5x the
    forward's causal FLOPs (the recompute of S and dP and the three
    products dV, dK, dQ) at the card's peak for the units the instance
    computes on (bfloat16's and float16's 989 TFLOP/s on the tensor cores
    for a 16-bit case, TF32's 495 for a float32 case on the tf32
    instance, float32's 67 outside the tensor cores for one on the FMA
    instance), against the bytes of q, k, v, out, dout, lse read and dq,
    dk, dv written;
    ``bf16_bound_us`` the same FLOPs at the bfloat16 peak whatever the
    dtype, and ``ceiling_us`` the instance's own: the wgmma design's 20 D
    FLOPs per scored (row, key) pair (S and dP in both kernels, the three
    products twice for the hi and lo halves) at the bfloat16 peak, the
    tf32 design's three TF32 passes of the 10 D at the TF32 peak (495
    TFLOP/s), the FMA design's 10 D at the float32 FMA peak. The library
    call:
    autograd's backward of ``scaled_dot_product_attention`` (causal, GQA)
    at the same shape, its forward taken once outside the timing."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_ref, backward_error_bound)
    from repro_torch.launch import roofline

    cases = []
    for label, dtype, impl, (B, S, H, HKV, D, window) in specs:
        q = (torch.randn((B, S, H, D), generator=g, device=dev)
             * D ** -0.5).to(dtype)
        k, v = (torch.randn((B, S, HKV, D), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        kw = dict(window=window, scale=1.0)
        out = fa_ops.flash_attention(q, k, v, lse=lse, **kw)
        args = (q, k, v, out, dout, lse)
        w = window or S
        pairs = sum(min(i + 1, w) for i in range(S))
        flops = 2.5 * 4 * B * H * D * pairs
        info = {"impl": impl,
                "bf16_bound_us": flops / roofline.BF16_FLOPS * 1e6}

        def cmp(args=args, kw=kw, label=label, info=info, impl=impl,
                flops=flops):
            # the instance's ceiling (set here, not when the case is made:
            # tools/kernel_ab.py makes these cases over older trees too)
            info["ceiling_us"] = {
                "wgmma": 2 * flops / roofline.BF16_FLOPS,
                "tf32": 3 * flops / roofline.TF32_FLOPS,
                "fma": flops / roofline.F32_FLOPS}[impl] * 1e6
            dtype, D = args[0].dtype, args[0].shape[-1]
            check(fa_ops.bwd_impl_for(dtype, D) == impl,
                  f"flash_attention_bwd {label}: bwd_impl_for gives "
                  f"{fa_ops.bwd_impl_for(dtype, D)}, expected {impl}")
            before = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
            got = fa_ops.flash_attention_backward(*args, **kw)
            names = bwd_launches_check(f"flash_attention_bwd {label}",
                                       before, impl)
            ran = traced_kernels(
                lambda: fa_ops.flash_attention_backward(*args, **kw),
                TRACE_NAME["flash_attention_bwd"])
            check(all(any(n + "<" in r for r in ran) for n in names)
                  and len(ran) == len(names),
                  f"flash_attention_bwd {label}: trace shows {ran}, "
                  f"expected {names}")
            again = fa_ops.flash_attention_backward(*args, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {label}: two calls differ")
            del again
            want = attention_backward_ref(*args, **kw)
            split = fa_ops.BWD_SPLIT[impl]
            bounds = backward_error_bound(*args, **kw, same_stats=True,
                                          split=split, ref=want)
            ratio = _bwd_ratio(got, want, bounds)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            info.update(tol="backward_error_bound(same_stats=True, "
                        f"split={split!r})",
                        err_over_tol=ratio, traced_kernels=ran,
                        bit_equal_twice=True)
            check(ratio <= 1.0, f"flash_attention_bwd {label}: error "
                  f"{ratio} x the bound (max abs {err})")
            del got, want, bounds
            return err

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True, scale=1.0)
        dout_t = dout.transpose(1, 2)
        cases.append(dict(
            name="flash_attention_bwd", shape=label,
            dims=dict(B=B, S=S, H=H, Hkv=HKV, D=D, dtype=str(dtype)[6:],
                      window=window, softcap=0.0),
            kernel=lambda args=args, kw=kw: fa_ops.flash_attention_backward(
                *args, **kw),
            plain=lambda args=args, kw=kw: attention_backward_ref(*args, **kw),
            compare=cmp, info=info,
            # milliseconds a call: 3 calls a timing
            reps=3,
            bytes=(4 * B * S * (H + HKV) * D * q.element_size()
                   + 4 * B * H * S),
            # the peak of the units the instance computes on, read when
            # the bound is (tools/kernel_ab.py makes these cases over older
            # trees, whose roofline may lack TF32_FLOPS)
            ops=flops, ops_rate=lambda dtype=dtype, impl=impl: (
                roofline.BF16_FLOPS if dtype in FLASH_ULP
                else roofline.TF32_FLOPS if impl == "tf32"
                else roofline.F32_FLOPS),
            library=lambda o=lib_out, d=dout_t, x=(qt, kt, vt):
                torch.autograd.grad(o, x, d, retain_graph=True)))
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
    # no Pallas counterpart: the reference's gradient is JAX's of
    # blockwise_attention, which this replaces; the main paths run its
    # wgmma instance
    "flash_attention_bwd": (FA_BWD_SOURCES["wgmma"],
                            "src/repro/models/layers.py:76"),
}


# the kernels line's instance entries beside the five kernels' (each at its
# ``path`` case, its launches summed over every instance and path): entry
# name -> (kernel, the case that times it, the instance, its source)
INSTANCE_ENTRIES = {
    "flash_attention_f16": ("flash_attention", "path_f16", "wgmma float16",
                            FA_KERNELS["wgmma"][0]),
    "flash_attention_scalar": ("flash_attention", "path_f32", "scalar",
                               FA_KERNELS["scalar"][0]),
    "flash_attention_bwd_tf32": ("flash_attention_bwd", "path_f32", "tf32",
                                 FA_BWD_SOURCES["tf32"]),
    "flash_attention_bwd_fma": ("flash_attention_bwd", "rg_f32", "fma",
                                FA_BWD_SOURCES["fma"]),
    "harmonize_tiled": ("harmonize", "long", "tiled",
                        KERNEL_META["harmonize"][0]),
}


def phase_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    at_path, at_lm, at_case = {}, {}, {}
    for case in kernel_cases(dev, g):
        err = case["compare"]()
        long_ = case["shape"] in ("sequence", LM_SHAPE["rglru_scan"]) or \
            case["name"].startswith("flash_attention")
        # timing only (the compare above is the check; tools/kernel_ab.py
        # is the instrument of record, and its 20-call readings agree with
        # these, PERF.md §6): 10 calls a timing for the long cases, 20 for
        # the others, 10 a profiled timing
        reps = case.get("reps", 10 if long_ else 20)
        calls = {k: call_ms(case[k], reps=reps) for k in
                 ("kernel", "plain", "library") if case[k] is not None}
        records = {}
        dev_ms = {k: device_ms(case[k], reps=min(reps, 10),
                               want=(TRACE_NAME[case["name"]],)
                               if k == "kernel" else (),
                               info=records if k == "kernel" else None)
                  for k in calls}
        timer = "profiler" if all(v is not None
                                  for v in dev_ms.values()) else "events"
        t = dev_ms if timer == "profiler" else calls
        ms, plain_ms, lib_ms = t["kernel"], t["plain"], t.get("library")
        rate = case.get("ops_rate")
        bound_ms, bound_by = bound(case["bytes"], case["ops"],
                                   rate() if callable(rate) else rate)
        us = lambda x: None if x is None else x * 1e3
        # the gradient's readings as shares of its bounds' pace
        shares = {f"{k[:-3]}_share": case["info"][k] / us(ms)
                  for k in ("bf16_bound_us", "ceiling_us")
                  if k in case.get("info", {}) and ms}
        emit(dict(kernel=case["name"], shape=case["shape"], **case["dims"],
                  at_s=time.perf_counter() - T_START,
                  parity="ok", max_abs_err=err, **case.get("info", {}),
                  timer=timer, **records, us=us(ms),
                  plain_us=us(plain_ms), library_us=us(lib_ms),
                  bound_us=us(bound_ms), bound_by=bound_by, **shares,
                  call_us=us(calls["kernel"]),
                  plain_call_us=us(calls["plain"]),
                  library_call_us=us(calls.get("library"))))
        impl = case.get("info", {}).get("impl")
        at_case[(case["name"], case["shape"])] = dict(
            **({"impl": impl} if impl else {}), max_abs_err=err,
            timer=timer, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms)
        if case["shape"] == "path":
            at_path[case["name"]] = at_case[(case["name"], "path")]
        if case["shape"] == LM_SHAPE.get(case["name"]):
            at_lm[case["name"]] = dict(
                shape=case["shape"], **case["dims"], max_abs_err=err,
                us=us(ms), plain_us=us(plain_ms), bound_us=us(bound_ms),
                bound_by=bound_by, library_us=us(lib_ms))
    return at_path, at_lm, at_case


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
    from torch.autograd import DeviceType
    with _trace(cpu=True) as prof:
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

    # the host launch times follow a profiled batch of the same engine,
    # so they take no warm-up call, and two calls (the phase is host-bound:
    # 108 s on a slow host with three and a warm-up)
    p_ms, p_acts = profile_step(plain_run, reps=1, want=LOOP_TRACE)
    out = {"unsharded": {"device_ms_per_batch": p_ms,
                         "device_activities_per_batch": p_acts,
                         "host_launch_ms_per_batch": host_launch_ms(
                             plain_run, reps=2, warm=True)}}
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
            "host_launch_ms_per_batch": host_launch_ms(run, reps=2,
                                                       warm=True),
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
    fn()
    missing = []
    for _ in range(3):
        with _trace(cpu=True) as prof:
            for _ in range(reps):
                fn()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy = _device_us(dev)
        missing = _missing(dev, want)
        if busy > 0 and not missing:
            return busy / reps / 1e3, sum(e.count for e in dev) / reps
    check(not missing, f"profile_step: every trace lacks kernels {missing}")
    return None, None


def host_launch_ms(fn, reps=20, warm=False):
    """Median host time to launch ``fn``'s work (no wait for the card),
    the card drained before each call; one untimed call first unless the
    caller has just run ``fn`` (``warm``)."""
    if not warm:
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
                                           raw.valid[0]), N_TICKS)
    hz_ops.LAUNCHES = 0
    hz_ops.LAUNCHES_BY_IMPL.update(warp=0, tiled=0)
    torch.cuda.synchronize()
    outs = [window(j) for j in range(k)]
    torch.cuda.synchronize()
    launches = hz_ops.LAUNCHES
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    check(launches == k, f"harmonize: {launches} launches, expected {k}")
    check(by_impl == {"warp": 0, "tiled": 0, impl: k},
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


def phase_harmonize_week(dev):
    """The harmonize op entry point over a week of 30 s ticks (HZ_WEEK: 64
    buildings x 8 sensors, 2048 samples a stream, T = 20,160, above the
    warp instance's MAX_T), as a user harmonizes a week of a 30 s sensor:
    one call, the launch counted by instance (all ``tiled``), the output
    finite where observed and bit-equal to the sequential loop on its
    first rows (phase 3's ``long`` case checks every row). Returns the
    tiled launches."""
    from repro_torch.kernels.harmonize import ops as hz_ops
    w = HZ_WEEK
    g = torch.Generator(device=dev).manual_seed(3)
    v, ts, ok, ws = _hz_samples(g, dev, w["e"], w["s"], w["m"], w["t"],
                                w["tick"])
    hz_ops.LAUNCHES = 0
    hz_ops.LAUNCHES_BY_IMPL.update(warp=0, tiled=0)
    (out, obs), wall_ms = _sync_ms(lambda: hz_ops.harmonize(
        v, ts, ok, ws, tick_s=w["tick"], n_ticks=w["t"]))
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    check(by_impl == {"warp": 0, "tiled": 1},
          f"harmonize_week: launches by instance {by_impl}")
    R, rows = w["e"] * w["s"], HZ_PLAIN_ROWS
    out, obs = out.reshape(R, w["t"]), obs.reshape(R, w["t"])
    check(bool(torch.isfinite(out[obs]).all()) and bool(obs.any()),
          "harmonize_week: means not finite where observed")
    seq, seq_obs = sequential_harmonize(
        v.reshape(R, -1)[:rows], ts.reshape(R, -1)[:rows],
        ok.reshape(R, -1)[:rows], ws.repeat_interleave(w["s"])[:rows],
        w["tick"], w["t"])
    check(torch.equal(obs[:rows], seq_obs) and bits_equal(out[:rows], seq),
          "harmonize_week: differs from the sequential loop")
    emit({"phase": "harmonize_week", **w, "rows": R,
          "launches_by_impl": by_impl, "first_call_wall_ms": wall_ms,
          "observed_frac": obs.float().mean().item(),
          "bit_equal_sequential_rows": rows})
    return by_impl["tiled"]


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _serve_drain(model, tag):
    """A ``ServeEngine`` drain at SERVE (``launch/serve.py``'s slots),
    every engine step timed (host clock, synchronized). The timing hook
    makes a cycle engine -> hook -> engine: the caller collects it."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    engine = ServeEngine(model, SERVE["slots"], SERVE["max_seq"])
    rng = np.random.RandomState(0)
    n = SERVE["requests"]
    lens = [SERVE["new_tokens"]] * n
    lens[0] = SERVE["refill_at"]
    lens[-1] = SERVE["new_tokens"] - SERVE["refill_at"]
    reqs = [Request(rid=i, prompt=rng.randint(
                1, cfg.vocab_size, (SERVE["prompt_len"],)).astype(np.int32),
                    max_new_tokens=lens[i])
            for i in range(n)]
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
              len(r.tokens) == r.max_new_tokens for r in reqs),
          f"{tag}: a request did not complete")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          f"{tag}: token out of range")
    check(engine.stats["admitted"] == engine.stats["retired"] == n
          and engine.stats["timeouts"] == 0, f"{tag}: stats {engine.stats}")
    # the last request went into a slot that an earlier one freed, within
    # the first wave's ticks
    check(engine.stats["admitted"] > SERVE["slots"] and
          engine.stats["ticks"] == SERVE["new_tokens"],
          f"{tag}: no slot was refilled within one wave ({engine.stats})")
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


# the float16 side-car (phase 7a): qwen3-0.6b with dtype = param_dtype =
# "float16", held against a float32 twin carrying the same weights at the
# depth the card fits (all 28 layers): the logits within LM_DECODE_BOUND
# (the bound bfloat16's decode holds; float16 keeps 3 more bits than
# bfloat16), and the argmax equal on every row whose float32 top-2 gap
# exceeds twice the largest difference, so that no rounding can flip it
LM_F16_TWIN_BOUND = LM_DECODE_BOUND


def phase_lm_float16(dev):
    """qwen3-0.6b at full width in float16 (``dataclasses.replace`` of the
    registry config): prefill 4 x 2048 with its 28 flash launches on the
    wgmma kernel's float16 instance (counted, and named in one profiler
    trace), decode against prefill (reported, as the families' drift is),
    one ServeEngine drain, then a float32 twin with the same weights at a
    fitted depth (its flash launches on the scalar instance). Returns the
    launches by instance: {"wgmma": prefill's, "scalar": the twin's}."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import LM
    from repro_torch.train import tree as tr

    tag = "lm_float16"
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float16",
                              param_dtype="float16")
    gc.collect()
    torch.cuda.empty_cache()
    model, init_ms = _sync_ms(lambda: LM(cfg, device=dev, seed=0))
    check(model.embed["table"].dtype == torch.float16, f"{tag}: weights")
    emit({"phase": tag, "step": "init", "arch": LM_ARCH,
          "layers": cfg.n_layers, "dtype": cfg.dtype,
          "params": model.param_count(), "param_bytes": model.param_bytes(),
          "init_ms": init_ms})
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (LM_B, LM_S), generator=g,
                         device=dev, dtype=torch.int32)
    model.prefill({"tokens": toks[:, :256]})   # warm-up
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    (full, _), first_ms = _sync_ms(lambda: model.prefill({"tokens": toks}))
    by_impl = dict(fa_ops.LAUNCHES_BY_IMPL)
    check(by_impl == {"wgmma": cfg.n_layers, "scalar": 0},
          f"{tag}: flash_attention launches by impl {by_impl}, expected "
          f"all {cfg.n_layers} on wgmma")
    check(full.shape == (LM_B, cfg.vocab_size) and full.dtype ==
          torch.float32 and bool(torch.isfinite(full).all()),
          f"{tag}: prefill logits not finite float32 (B, V)")
    walls = [_sync_ms(lambda: model.prefill({"tokens": toks}))[1]
             for _ in range(3)]
    wall = statistics.median(walls)
    emit({"phase": tag, "step": "prefill", "batch": LM_B, "seq": LM_S,
          "flash_attention_launches_by_impl": by_impl,
          "first_wall_ms": first_ms, "wall_ms": wall, "wall_ms_runs": walls,
          "tokens_per_s": LM_B * LM_S / (wall / 1e3)})
    rel = _decode_vs_prefill(model, {"tokens": toks}, "tokens")
    emit({"phase": tag, "step": "decode_vs_prefill", **rel,
          "checked": False})
    emit({"phase": tag, "step": "serve", **_serve_drain(model, tag)})
    gc.collect()   # the drain's timing hook held a cycle to the model
    part = FA_KERNELS["wgmma"][1]
    prof = _profile_step(lambda: model.prefill({"tokens": toks}), tag,
                         {part: cfg.n_layers})
    names = prof["traced"][part]["kernels"]
    check(names and all("half" in k and "bfloat16" not in k for k in names),
          f"{tag}: the traced flash kernels {names} are not the float16 "
          "instance")
    emit({"phase": tag, "step": "profile_prefill", **prof})

    # the float32 twin: the same weights upcast, at the depth the card fits
    # beside the float16 model
    cfg32 = _fit_depth(dataclasses.replace(cfg, dtype="float32",
                                           param_dtype="float32"))
    n = cfg32.n_layers
    if n < cfg.n_layers:
        del model.layers[n:]
        model.cfg = dataclasses.replace(cfg, n_layers=n)
        full, _ = model.prefill({"tokens": toks})
    params = model.params()
    twin = LM(cfg32, device=dev, params=tr.map_(lambda x: x.float(),
                                                params))
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    want, _ = twin.prefill({"tokens": toks})
    twin_by_impl = dict(fa_ops.LAUNCHES_BY_IMPL)
    check(twin_by_impl == {"wgmma": 0, "scalar": n},
          f"{tag}: the float32 twin's flash launches {twin_by_impl}")
    diff = (full - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = full.argmax(-1) == want.argmax(-1)
    emit({"phase": tag, "step": "float32_twin",
          "layers": f"{n} of {cfg.n_layers}", "bound": LM_F16_TWIN_BOUND,
          "max_abs_diff": diff, "max_abs_logit": want.abs().max().item(),
          "argmax_agree": int(agree.sum()), "rows": LM_B,
          "top2_gap_min": gap.min().item(),
          "flash_launches_by_impl": twin_by_impl})
    check(diff <= LM_F16_TWIN_BOUND, f"{tag}: float16 against float32 max "
          f"abs diff {diff} > {LM_F16_TWIN_BOUND}")
    check(bool((agree | (gap <= 2 * diff)).all()),
          f"{tag}: float16 and float32 disagree on a clear argmax")
    del model, twin, params, full, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"wgmma": by_impl["wgmma"], "scalar": twin_by_impl["scalar"]}


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
# the free memory beside the weights at which a family's prefill is
# profiled: with 12 GiB (phi3.5 at 27 layers) three traces of its prefill
# each lost one of 27 flash kernels in one run of two; at 16 GiB (25
# layers) none did. The profile drops trailing layers to make this room;
# the checks and timings above it run at the depth FIT_RESERVE_BYTES allows
PROFILE_RESERVE_BYTES = 16 << 30


def _fit_depth(cfg, reserve=FIT_RESERVE_BYTES):
    """``cfg`` with as many of its layers as fit in the card's free memory
    beside ``reserve`` (all of them where they fit), never less than one
    whole period of its layer pattern."""
    import dataclasses

    from repro_torch.models import param as P
    from repro_torch.models.model import param_defs
    free = torch.cuda.mem_get_info()[0] - reserve
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
    §7) is taken again, up to ``tries`` times, then the check fails;
    ``traced_by_attempt`` has each trace's launches of ``want`` and
    ``device_window_ms`` each trace's ``device_window_ms``."""
    from torch.autograd import DeviceType
    by_attempt, windows = [], []
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with _trace() as prof:
            # [1]: the call's output is dropped before a retry runs (a
            # train step's new state is 27 GB at recurrentgemma-2b)
            wall = _sync_ms(fn)[1]
        windows.append(device_window_ms(prof))
        devs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        traced = {}
        for part in want:
            hits = [e for e in devs if part in e.key]
            traced[part] = {"kernels": sorted({e.key for e in hits}),
                            "launches": sum(e.count for e in hits),
                            "device_ms": sum(e.self_device_time_total
                                             for e in hits) / 1e3}
        by_attempt.append({p: traced[p]["launches"] for p in want})
        if all(traced[p]["launches"] == n for p, n in want.items()):
            break
    for part, n in want.items():
        check(traced[part]["launches"] == n,
              f"{name}: the trace shows {traced[part]['launches']} "
              f"launches of {part} kernels ({traced[part]['kernels']}), "
              f"expected {n}; by trace {by_attempt}, device window "
              f"{windows} ms with {TRACE_PAD_S * 1e3} ms pads")
    top = sorted(devs, key=lambda e: -e.self_device_time_total)[:6]
    busy = _device_us(devs) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "traces": attempt,
            "traced_by_attempt": by_attempt, "device_window_ms": windows,
            "trace_pad_ms": TRACE_PAD_S * 1e3,
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
    prof_cfg = _fit_depth(full, PROFILE_RESERVE_BYTES)
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

    # last, so that no timing above runs after the profiler has run; at
    # the depth with the profiler's room (PROFILE_RESERVE_BYTES): the
    # trailing layers beyond it are dropped from the model
    if prof_cfg.n_layers < cfg.n_layers:
        del model.layers[prof_cfg.n_layers:]
        model.cfg = prof_cfg
        gc.collect()
        torch.cuda.empty_cache()
    kinds = prof_cfg.layer_kinds
    want = {}
    if n_attn:
        want[FA_KERNELS["wgmma"][1]] = sum(
            k in (ATTN_GLOBAL, ATTN_LOCAL) for k in kinds)
    if n_rglru:
        want["rglru_scan_kernel"] = sum(k == RGLRU for k in kinds)
    prof = _profile_step(lambda: model.prefill(inputs), tag, want)
    emit({"phase": tag, "step": "profile_prefill",
          "layers": f"{prof_cfg.n_layers} of {full.n_layers}", **prof})
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


# LM training (phases 9 and 10): qwen3-0.6b at train_4k's sequence, the
# global batch cut from 256 to 4 (one card, and the script's time: 8 took
# ~55 s of a ~850 s run) in 2 microbatches of 2; recurrentgemma-2b at
# 2 x 2048 in one microbatch. Both full remat, AdamW from the seeded
# init, the same batch repeated (so the loss must fall)
TRAIN = dict(arch="qwen3-0.6b", seq=4096, batch=4, micro=2, steps=5)
TRAIN_RG = dict(arch="recurrentgemma-2b", seq=2048, batch=2, micro=1)
TRAIN_LR = 1e-3
# RGLRUScanFn's gradients against autograd through its plain loop on the
# card: each within this share of the gradient's largest magnitude (the
# kernel adds in autograd's order; expected bit-equal). FlashAttentionFn's
# are held to ``ref.backward_error_bound`` instead: its backward is the
# gradient kernel, another algorithm than autograd through attention_ref
TRAIN_GRAD_REL = 1e-6
# the train steps before the gradient kernel (autograd through
# attention_ref), as this script read them on an NVIDIA H100 80GB HBM3 at
# 700 W: step ms and peak device bytes, reported beside this run's
TRAIN_BEFORE = {"qwen3-0.6b": {"step_ms": 3169, "peak_device_bytes": 26.5e9},
                "recurrentgemma-2b": {"step_ms": 625.8,
                                      "peak_device_bytes": 59.0e9}}


def _max_rel(got, want):
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def tree_digest(t, chunk=1 << 24):
    """Two int64 sums per leaf over its raw bits (plain, and weighted by
    the position mod 65521), taken in chunks: equal trees give equal
    digests, and a changed bit changes them; compares two trees too large
    to hold at once."""
    from repro_torch.train import tree
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for x in tree.leaves(t):
        flat = x.detach().contiguous().view(ints[x.element_size()]).reshape(-1)
        a = b = 0
        for i in range(0, flat.numel(), chunk):
            c = flat[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521
            a += int(c.sum())
            b += int((c * w).sum())
        out.append((a, b))
    return out


def _train_setup(dev, spec):
    """The train step at full width (``launch.steps.build_train_step``),
    its params and AdamW state, and one batch of the synthetic stream on
    the card."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree

    cfg = get_config(spec["arch"])
    shape = ShapeConfig("train", spec["seq"], spec["batch"], "train")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=100, microbatches=spec["micro"],
                       remat_policy="full")
    (step, model), init_ms = _sync_ms(
        lambda: build_train_step(cfg, shape, tcfg, dev))
    params = tree.map_(lambda x: x.detach(), model.params())
    state = opt.init(params)
    batch = to_device(SyntheticLMStream(
        cfg.vocab_size, spec["batch"], spec["seq"], seed=0).make_batch(0),
        dev)
    return cfg, step, model, params, state, batch, init_ms


def _train_readings(cfg, spec, n_params, step_ms, prof):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    tokens = spec["batch"] * spec["seq"]
    return {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "device_kernels": prof["device_kernels"],
            "traces": prof["traces"],
            "top_device_ms": prof["top_device_ms"],
            # a reading, not a claim: the reference's MODEL_FLOPS (6 N D,
            # N without the input embedding) over the step time, as a
            # share of the bf16 dense peak
            "model_flop_share_of_bf16_peak": roofline.flop_share(
                cfg, ShapeConfig("train", spec["seq"], spec["batch"],
                                 "train"), step_ms / 1e3)}


def _zero_bwd():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fa_ops.LAUNCHES_BWD = 0
    fa_ops.LAUNCHES_BWD_BY_KERNEL.update(dict.fromkeys(FA_BWD_KERNELS, 0))


def phase_lm_train(dev):
    """qwen3-0.6b training at full width (TRAIN): (a) FlashAttentionFn at
    the microbatch's shape against autograd through ``attention_ref`` on
    the card, forward within the one-ulp bound and (dq, dk, dv), the
    gradient's wgmma instance (one launch of each of its kernels,
    ``bwd_expected``), within ``ref.backward_error_bound(split=True)``
    (the plain side recomputes its own softmax statistics); then the train
    step: its flash-attention launches counted (28 a microbatch, and 28
    again for the full remat's recompute) and its gradient launches (28 a
    microbatch of each of the wgmma instance's four kernels), (b) a second
    step from the same state and batch bit for bit, (c) the loss falling
    over TRAIN["steps"] steps on the batch,
    (d) a profiled step whose trace names the forward and the four
    gradient kernels as often as counted. Readings: step ms, tokens/s,
    device busy ms and idle share, peak memory (beside the step's before
    the gradient kernel, TRAIN_BEFORE), the model-FLOP share of the bf16
    peak. Returns the
    step's launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, backward_error_bound)
    from repro_torch.models.layers import FlashAttentionFn

    tag = "lm_train"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, step, model, params, state, batch, init_ms = _train_setup(
        dev, TRAIN)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
           cfg.param_dtype) == (28, 1024, 151936, "bfloat16", "bfloat16"),
          f"{tag}: not the full-width config")
    n_params = model.param_count()
    emit({"phase": tag, "step": "init", "arch": TRAIN["arch"],
          "source": cfg.source, "params": n_params,
          "param_bytes": model.param_bytes(), "init_ms": init_ms,
          "seq": TRAIN["seq"], "global_batch": TRAIN["batch"],
          "microbatches": TRAIN["micro"], "remat_policy": "full",
          "reduced": f"global batch 256 -> {TRAIN['batch']} (one card)"})

    # (a) the kernel against its plain version at the microbatch's shape
    mb = TRAIN["batch"] // TRAIN["micro"]
    H, HKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((mb, TRAIN["seq"], h, D), generator=g,
                           device=dev).to(torch.bfloat16) for h in
               (H, HKV, HKV))
    q = (q * D ** -0.5).requires_grad_()
    k, v = k.requires_grad_(), v.requires_grad_()
    dout = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    before = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    out = FlashAttentionFn.apply(q, k, v, 0, 0.0)
    got = torch.autograd.grad(out, (q, k, v), dout)
    bwd_launches_check(f"{tag}: FlashAttentionFn", before)
    ref = attention_ref(q, k, v, scale=1.0)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    fwd = ((out.float() - ref.float()).abs()
           / (2.0 ** -7 * ref.float().abs() + 1e-5)).max().item()
    del ref
    qd, kd, vd = (x.detach() for x in (q, k, v))
    lse = torch.empty((mb, H, TRAIN["seq"]), dtype=torch.float32,
                      device=dev)
    fa_ops.flash_attention(qd, kd, vd, scale=1.0, lse=lse)
    bounds = backward_error_bound(qd, kd, vd, out.detach(), dout, lse,
                                  scale=1.0, split=True, ref=want)
    grad_ratio = _bwd_ratio(got, want, bounds)
    grad_rel = _max_rel(got, want)
    check(fwd <= 1.0, f"{tag}: FlashAttentionFn forward {fwd} x the "
          "one-ulp bound")
    check(grad_ratio <= 1.0, f"{tag}: FlashAttentionFn (dq, dk, dv) "
          f"{grad_ratio} x their bound from autograd through attention_ref "
          f"(max rel {grad_rel})")
    emit({"phase": tag, "step": "flash_attention_fn", "shape": list(q.shape),
          "kv_heads": HKV, "forward_err_over_one_ulp": fwd,
          "grad_err_over_bound": grad_ratio,
          "grad_bound": "backward_error_bound(same_stats=False, "
                        "split=True)",
          "grad_max_rel_err": grad_rel,
          "grad_max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want))})
    del q, k, v, qd, kd, vd, lse, dout, out, got, want, bounds
    gc.collect()
    torch.cuda.empty_cache()

    # the path: one step with the launches counted
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    _zero_bwd()
    first, first_ms = _sync_ms(lambda: step(params, state, batch))
    launches = fa_ops.LAUNCHES
    bwd = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    per_step = 2 * cfg.n_layers * TRAIN["micro"]
    check(launches == per_step and fa_ops.LAUNCHES_BY_IMPL ==
          {"wgmma": per_step, "scalar": 0},
          f"{tag}: {fa_ops.LAUNCHES_BY_IMPL} flash_attention launches in "
          f"one step, expected {per_step} on wgmma (forward + remat)")
    want_bwd = bwd_expected(cfg.n_layers * TRAIN["micro"])
    check(bwd == want_bwd and fa_ops.LAUNCHES_BWD == sum(want_bwd.values()),
          f"{tag}: gradient launches {bwd} in one step, expected "
          f"{want_bwd}")
    losses = [first[2]["loss"].item()]
    check(all(bool(torch.isfinite(x).all()) for x in first[2].values()),
          f"{tag}: metrics not finite {first[2]}")
    # (b) the same state and batch once more: the same bits
    second = step(params, state, batch)
    check(tree_bits_equal(first, second), f"{tag}: two steps from one "
          "state and batch differ")
    del second
    # (c) the loss falls on the repeated batch; the module follows the
    # params (``load_params``), so the weights it was built with are freed
    params, state = first[0], first[1]
    model.load_params(params)
    del first
    walls = []
    for _ in range(TRAIN["steps"] - 1):
        (params, state, met), ms = _sync_ms(
            lambda: step(params, state, batch))
        model.load_params(params)
        walls.append(ms)
        losses.append(met["loss"].item())
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall over "
          f"{TRAIN['steps']} steps: {losses}")
    peak = torch.cuda.max_memory_allocated()
    # (d) the kernels in a trace of one step
    prof = _profile_step(lambda: step(params, state, batch), tag,
                         {FA_KERNELS["wgmma"][1]: per_step,
                          **{FA_BWD_KERNELS[k]: n
                             for k, n in want_bwd.items() if n}})
    step_ms = statistics.median(walls)
    emit({"phase": tag, "step": "train", "launches_per_step":
          {"flash_attention": launches, "flash_attention_bwd": bwd},
          "first_step_ms": first_ms,
          "step_ms_runs": walls, "losses": losses, "bit_equal_twice": True,
          "peak_device_bytes": peak, "grad_norm": met["grad_norm"].item(),
          "before_gradient_kernel": TRAIN_BEFORE[TRAIN["arch"]],
          **_train_readings(cfg, TRAIN, n_params, step_ms, prof)})
    del model, step, params, state, batch, met
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": launches,
            "flash_attention_bwd": sum(bwd.values())}


def phase_lm_train_rglru(dev):
    """recurrentgemma-2b training at full width (TRAIN_RG): (a)
    RGLRUScanFn at the step's shape, forward bit for bit against the plain
    loop and (da, db, dh0) within TRAIN_GRAD_REL of autograd through it on
    the card; the step with its rglru_scan launches counted (18 forward,
    16 again for the remat of the 8 pattern groups (the 2 tail layers are
    not rematted, as in the reference), 18 reversed scans in the backward)
    and its flash-attention launches (8 + 8) and gradient launches (8 of
    each of its four kernels); (b) two steps from one state and batch with equal losses and equal digests of the new params and
    AdamW state (the card holds one new state beside the old, not two);
    (c) the loss falling on the next step over the same batch; (d) a
    profiled step naming both kernels as often as counted. Returns the
    step's launches."""
    from repro_torch.configs.base import ATTN_LOCAL, RGLRU
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models.rglru import RGLRUScanFn

    tag = "lm_train_rglru"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg, step, model, params, state, batch, init_ms = _train_setup(
        dev, TRAIN_RG)
    check((cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.dtype) ==
          (26, 2560, 2560, "bfloat16"), f"{tag}: not the full-width config")
    kinds = cfg.layer_kinds
    n_pat = len(cfg.layer_pattern)
    grouped = kinds[:cfg.n_groups * n_pat]
    n_rg, n_rg_g = kinds.count(RGLRU), grouped.count(RGLRU)
    n_fa, n_fa_g = kinds.count(ATTN_LOCAL), grouped.count(ATTN_LOCAL)
    n_params = model.param_count()
    emit({"phase": tag, "step": "init", "arch": TRAIN_RG["arch"],
          "source": cfg.source, "params": n_params,
          "param_bytes": model.param_bytes(), "init_ms": init_ms,
          "seq": TRAIN_RG["seq"], "global_batch": TRAIN_RG["batch"],
          "microbatches": TRAIN_RG["micro"], "remat_policy": "full",
          "rglru_layers": n_rg, "rglru_layers_in_groups": n_rg_g,
          "attention_layers": n_fa, "device_bytes_before": before})

    # (a) the scan against its plain loop at the step's shape
    B, T, W = TRAIN_RG["batch"], TRAIN_RG["seq"], cfg.lru_width
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.rand((B, T, W), generator=g, device=dev).requires_grad_()
    b = (0.1 * torch.randn((B, T, W), generator=g, device=dev)
         ).requires_grad_()
    h0 = torch.randn((B, W), generator=g, device=dev).requires_grad_()
    w1 = torch.randn((B, T, W), generator=g, device=dev)
    w2 = torch.randn((B, W), generator=g, device=dev)
    hs, hl = RGLRUScanFn.apply(a, b, h0)
    got = torch.autograd.grad((hs * w1).sum() + (hl * w2).sum(), (a, b, h0))
    hs2, hl2 = rglru_scan_ref(a, b, h0)
    check(torch.equal(hs, hs2) and torch.equal(hl, hl2),
          f"{tag}: RGLRUScanFn forward differs from the plain loop")
    want = torch.autograd.grad((hs2 * w1).sum() + (hl2 * w2).sum(),
                               (a, b, h0))
    grad_rel = _max_rel(got, want)
    check(grad_rel <= TRAIN_GRAD_REL, f"{tag}: RGLRUScanFn (da, db, dh0) "
          f"{grad_rel} of their max from autograd through the plain loop")
    emit({"phase": tag, "step": "rglru_scan_fn", "shape": [B, T, W],
          "forward_bit_equal": True, "grad_max_rel_err": grad_rel,
          "grad_bound": TRAIN_GRAD_REL,
          "grad_bit_equal": all(torch.equal(x, y)
                                for x, y in zip(got, want))})
    del a, b, h0, w1, w2, hs, hl, hs2, hl2, got, want
    gc.collect()
    torch.cuda.empty_cache()

    rglru_ops.LAUNCHES = 0
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    _zero_bwd()
    once, first_ms = _sync_ms(lambda: step(params, state, batch))
    launches = {"rglru_scan": rglru_ops.LAUNCHES,
                "flash_attention": fa_ops.LAUNCHES,
                "flash_attention_bwd": fa_ops.LAUNCHES_BWD}
    want_bwd = bwd_expected(n_fa)
    expect = {"rglru_scan": 2 * n_rg + n_rg_g,
              "flash_attention": n_fa + n_fa_g,
              "flash_attention_bwd": sum(want_bwd.values())}
    check(launches == expect and fa_ops.LAUNCHES_BY_IMPL["wgmma"] ==
          expect["flash_attention"] and fa_ops.LAUNCHES_BWD_BY_KERNEL ==
          want_bwd, f"{tag}: launches "
          f"{launches} ({fa_ops.LAUNCHES_BY_IMPL}, "
          f"{fa_ops.LAUNCHES_BWD_BY_KERNEL}) in one step, expected {expect}")
    # (b) one state and batch twice: compared by digest (two new states
    # beside the old one would not fit)
    digest, loss0 = tree_digest(once[:2]), once[2]["loss"].item()
    check(all(bool(torch.isfinite(x).all()) for x in once[2].values()),
          f"{tag}: metrics not finite")
    del once
    gc.collect()
    first, ms = _sync_ms(lambda: step(params, state, batch))
    walls = [ms]
    check(first[2]["loss"].item() == loss0 and
          tree_digest(first[:2]) == digest,
          f"{tag}: two steps from one state and batch differ")
    # (c) the next step on the same batch lowers the loss; the module
    # follows the params, so the weights it was built with are freed
    params, state = first[0], first[1]
    model.load_params(params)
    del first
    (params, state, met), ms = _sync_ms(lambda: step(params, state, batch))
    model.load_params(params)
    walls.append(ms)
    losses = [loss0, met["loss"].item()]
    check(losses[1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_step(lambda: step(params, state, batch), tag,
                         {"rglru_scan_kernel": expect["rglru_scan"],
                          FA_KERNELS["wgmma"][1]: expect["flash_attention"],
                          **{FA_BWD_KERNELS[k]: n
                             for k, n in want_bwd.items() if n}})
    step_ms = statistics.median(walls)
    emit({"phase": tag, "step": "train", "launches_per_step": launches,
          "first_step_ms": first_ms, "step_ms_runs": walls,
          "losses": losses, "digest_equal_twice": True,
          "peak_device_bytes": peak,
          "before_gradient_kernel": TRAIN_BEFORE[TRAIN_RG["arch"]],
          **_train_readings(cfg, TRAIN_RG, n_params, step_ms, prof)})
    del model, step, params, state, batch, met
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The model-sharding phase (phase 11): the LM on (data, model) meshes of
# logical shards of the card (a mesh naming the card 8 or 4 times), at
# published widths. qwen3-0.6b on (2, 4): a ZeRO-3 train step at 4 x 2048
# (one microbatch, full remat, bf16), two steps from one state, the float32
# twin against the unsharded float32 step (at SHARD_F32's shape), a
# sharded prefill; phi3.5-moe-42b-a6.6b on (2, 4), its depth cut to what
# fits a train step (~24 bytes a param: params, AdamW state, grads, the new
# state, the dense twin's), at a capacity that cannot drop, against the
# dense unsharded step, in bf16 and in a float32 twin; recurrentgemma-2b
# on (2, 2) in float32: a sharded prefill and SHARD_DECODE decode steps
# with the cache's slots split over model, against the unsharded model
SHARD_QWEN = dict(arch="qwen3-0.6b", mesh=(2, 4), seq=2048, batch=4)
SHARD_F32 = dict(seq=512, batch=4)
SHARD_MOE = dict(arch="phi3.5-moe-42b-a6.6b", mesh=(2, 4), seq=1024,
                 batch=2)
SHARD_RG = dict(arch="recurrentgemma-2b", mesh=(2, 2), prompt=504,
                max_seq=512, batch=4)
SHARD_DECODE = 8
SHARD_TRAIN_BYTES_PER_PARAM = 24
# tests/test_torch_model_sharded_steps.py's bounds (lr 1e-3, warmup 2):
# the loss within rtol 1e-5; AdamW's m and v (the first step's (1 - b1) g
# and (1 - b2) g^2) within 1e-4 of each leaf's largest magnitude; the new
# params within ADAM_BOUND
# elementwise (that file's adam_bound: the gap lr |F_got - F_want| that
# the two new AdamW states give in exact arithmetic, F = m^ / (sqrt(v^) +
# eps), plus the two updates' roundings counted from their ops, eps32 (lr
# (8 max |F| + 4 wd |p|) + |p|))
SHARD_LOSS_RTOL = 1e-5
SHARD_GRAD_REL = 1e-4
# the float32 twin's params, absolute: a guard against a gross fault, set
# after this phase's first run read 1.494e-5 (the largest gaps sit where
# |g| is near AdamW's eps, where F's slope is 1 / eps); ADAM_BOUND is the
# elementwise check. It guards qwen3-0.6b's twins (here and with
# seq_parallel in lm_sharded_more). The other archs' twins there hold m, v
# and ADAM_BOUND and report their largest gap, which no absolute number
# can split into sound and faulty: a first AdamW step moves each param by
# lr F with F ~ g / (|g| + eps), ~sign(g): a sound twin reads up to ~lr
# where |g| is near eps (rwkv6-1.6b: 2.8e-4), and a fault that scales a
# gradient (a sum over too few shards) keeps the signs and reads no more;
# m, v and ADAM_BOUND, elementwise, tell the two apart
SHARD_F32_PARAM_ATOL = 2e-5
# float32 logits of a sharded serving step against the unsharded one:
# |d| <= atol + rtol |ref|
SHARD_F32_ATOL = SHARD_F32_RTOL = 1e-3
# the MoE step against the dense one, in bf16 and in a float32 twin: the
# cross entropy within 1e-3 (bf16) or SHARD_LOSS_RTOL (float32), the grad
# norm within 1e-3 (this phase's first bf16 run read 8.6e-5 and 1.0e-4;
# the grad norm carries the aux loss, which differs by construction, the
# sharded one averaging the data shards' load terms); in float32, AdamW's
# m of every leaf the aux loss does not reach (the last layer's experts,
# the final norm, the head) within SHARD_GRAD_REL of the leaf's largest.
# bf16 reports its m only: a bf16 rounding of an activation can flip a
# token's top-2 experts where router logits nearly tie, moving that
# token's whole gradient between experts (the likely cause of the
# 0.20-0.27 that the phase's second run read); the float32 twin checks
SHARD_MOE_CE_RTOL = SHARD_MOE_GNORM_RTOL = 1e-3


def _zero_counts():
    from repro_torch.distribution import collectives as col
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    fa_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BY_IMPL.update(wgmma=0, scalar=0)
    fa_ops.LAUNCHES_BY_OFFSET.clear()
    fa_ops.LAUNCHES_BWD = 0
    fa_ops.LAUNCHES_BWD_BY_KERNEL.update(dict.fromkeys(FA_BWD_KERNELS, 0))
    rglru_ops.LAUNCHES = 0
    for k in col.CALLS:
        col.CALLS[k] = 0


def _read_counts():
    from repro_torch.distribution import collectives as col
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    by_offset, offset_by_impl = {}, dict.fromkeys(fa_ops.LAUNCHES_BY_IMPL, 0)
    for (impl, off), n in sorted(fa_ops.LAUNCHES_BY_OFFSET.items(),
                                 key=lambda kv: kv[0][1]):
        by_offset[str(off)] = by_offset.get(str(off), 0) + n
        offset_by_impl[impl] += n if off else 0
    return {"flash_attention": fa_ops.LAUNCHES,
            "flash_by_impl": dict(fa_ops.LAUNCHES_BY_IMPL),
            "flash_by_offset": by_offset,
            "flash_offset_by_impl": offset_by_impl,
            "flash_bwd": dict(fa_ops.LAUNCHES_BWD_BY_KERNEL),
            "rglru_scan": rglru_ops.LAUNCHES, "collectives": dict(col.CALLS)}


def _logical_mesh(dev, shape):
    from repro_torch.launch.mesh import make_mesh
    n = shape[0] * shape[1]
    return make_mesh(shape, devices=[dev] * n)


def _sharded_train(cfg, shape, tcfg, mesh, params, batch, perf=None):
    """The sharded step, its model, its layouts and its inputs placed on
    ``mesh``."""
    from repro_torch.configs.base import ShardingConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps
    perf = perf or ShardingConfig()
    step, model = steps.build_train_step(
        cfg, shape, tcfg, mesh=mesh, perf=perf,
        model=steps.make_model(cfg, perf, mesh, params=params))
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    os_ = steps.init_opt_state(params, mesh, lay)
    bs = shd.place_tree(batch, lay["batch"](batch), mesh)
    return step, model, lay, ps, os_, bs


def _plain_train(cfg, shape, tcfg, dev, params):
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import LM
    from repro_torch.train import optimizer as opt
    step, _ = build_train_step(cfg, shape, tcfg, dev,
                               model=LM(cfg, device=dev, params=params))
    return step, opt.init(params)


def _max_abs(a, b):
    from repro_torch.train import tree
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _adam_ratio(p_got, p_want, p_old, o_got, o_want, lr, tcfg):
    """The largest |dp| over ADAM_BOUND (<= 1 within it) of an AdamW step
    from the new states ``o_got`` and ``o_want``
    (tests/test_torch_model_sharded_steps.py::adam_bound: lr |F_got -
    F_want| + R, R = eps32 (lr (8 max |F| + 4 wd |p|) + |p|)), the largest
    share of R that a gap takes beyond its exact part, and the worst
    element's terms."""
    from repro_torch.train import tree
    f32 = lambda x: float(np.float32(x))
    t = o_want["step"].float().cpu()
    c1 = float(1.0 - torch.pow(tcfg.beta1, t))
    c2 = float(1.0 - torch.pow(tcfg.beta2, t))
    eps, wd = f32(tcfg.eps), f32(tcfg.weight_decay)
    ulp = torch.finfo(torch.float32).eps
    worst, excess = (0.0, {}), 0.0
    chunk = 1 << 24            # elements at a time: float64 temporaries
    for leaf in zip(tree.leaves(p_got), tree.leaves(p_want),
                    tree.leaves(p_old), tree.leaves(o_got["m"]),
                    tree.leaves(o_want["m"]), tree.leaves(o_got["v"]),
                    tree.leaves(o_want["v"])):
        shape = list(leaf[0].shape)
        flat = [x.reshape(-1) for x in leaf]
        for c0 in range(0, flat[0].numel(), chunk):
            pg, pw, po, mg, mw, vg, vw = (x[c0:c0 + chunk] for x in flat)
            fg = (mg.double() / c1) / (torch.sqrt(vg.double() / c2) + eps)
            fw = (mw.double() / c1) / (torch.sqrt(vw.double() / c2) + eps)
            exact = lr * (fg - fw).abs()
            p = po.double().abs()
            rnd = ulp * (lr * (8 * torch.maximum(fg.abs(), fw.abs())
                               + 4 * wd * p) + p)
            dp = (pg.double() - pw.double()).abs()
            r = dp / (exact + rnd)
            excess = max(excess, ((dp - exact) / rnd).max().item())
            j = int(r.argmax())
            if r[j].item() > worst[0]:
                worst = (r[j].item(), {
                    "dp": dp[j].item(), "exact": exact[j].item(),
                    "rounding": rnd[j].item(), "F": fw[j].item(),
                    "g": mw[j].item() / (1.0 - tcfg.beta1),
                    "p": po[j].item(), "shape": shape})
            del fg, fw, exact, p, rnd, dp, r
    return worst[0], excess, worst[1]


def _f32_ratio(got, want):
    return ((got - want).abs() / (SHARD_F32_ATOL + SHARD_F32_RTOL
                                  * want.abs())).max().item()


def _shard_qwen(dev, readings):
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.distribution import sharding as shd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import build_prefill_step, make_model
    from repro_torch.models import LM
    from repro_torch.train import tree

    tag = "lm_sharded_qwen3"
    spec = SHARD_QWEN
    cfg = get_config(spec["arch"])
    mesh = _logical_mesh(dev, spec["mesh"])
    n_sh = mesh.size
    shape = ShapeConfig("train", spec["seq"], spec["batch"], "train")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=100, remat_policy="full")
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=dev, seed=0).params())
    batch = to_device(SyntheticLMStream(cfg.vocab_size, spec["batch"],
                                        spec["seq"], seed=0).make_batch(0),
                      dev)
    torch.cuda.reset_peak_memory_stats()
    step, _, lay, ps, os_, bs = _sharded_train(cfg, shape, tcfg, mesh, params,
                                            batch)
    per_step = n_sh * cfg.n_layers * 2
    _zero_counts()
    first, first_ms = _sync_ms(lambda: step(ps, os_, bs))
    counts = _read_counts()
    check(counts["flash_attention"] == per_step and
          counts["flash_by_impl"] == {"wgmma": per_step, "scalar": 0},
          f"{tag}: {counts['flash_by_impl']} flash_attention launches in a "
          f"step on {n_sh} shards, expected {per_step} on wgmma")
    want_bwd = bwd_expected(n_sh * cfg.n_layers)
    check(counts["flash_bwd"] == want_bwd,
          f"{tag}: gradient launches {counts['flash_bwd']} in a step on "
          f"{n_sh} shards, expected {want_bwd}")
    check(all(bool(torch.isfinite(v).all()) for v in first[2].values()),
          f"{tag}: metrics not finite {first[2]}")
    digest, loss0 = tree_digest(first[:2]), first[2]["loss"].item()
    readings["qwen3_loss"] = loss0
    del first
    second, ms = _sync_ms(lambda: step(ps, os_, bs))
    walls = [ms]
    check(second[2]["loss"].item() == loss0 and
          tree_digest(second[:2]) == digest,
          f"{tag}: two sharded steps from one state differ")
    del second
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_step(lambda: step(ps, os_, bs), tag,
                         {FA_KERNELS["wgmma"][1]: per_step})
    del step, ps, os_, bs
    gc.collect()
    torch.cuda.empty_cache()
    plain, opt0 = _plain_train(cfg, shape, tcfg, dev, params)
    plain_walls = [_sync_ms(lambda: plain(params, opt0, batch))[1]
                   for _ in range(2)][1:]
    del plain, opt0
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = statistics.median(walls)
    plain_ms = statistics.median(plain_walls)
    emit({"phase": tag, "step": "train", "arch": spec["arch"],
          "mesh": dict(zip(("data", "model"), spec["mesh"])),
          "logical_shards": n_sh, "layout": "zero3", "seq": spec["seq"],
          "global_batch": spec["batch"], "microbatches": 1,
          "remat_policy": "full", "dtype": cfg.dtype,
          "flash_shape_per_shard": [spec["batch"] // spec["mesh"][0],
                                    spec["seq"],
                                    cfg.n_heads // spec["mesh"][1],
                                    cfg.resolved_head_dim],
          "kv_heads_per_shard": cfg.n_kv_heads // spec["mesh"][1],
          "launches_per_step": {"flash_attention": counts["flash_attention"],
                                "flash_attention_bwd": counts["flash_bwd"]},
          "collective_calls_per_step": counts["collectives"],
          "first_step_ms": first_ms, "step_ms_runs": walls,
          "step_ms": step_ms, "unsharded_step_ms_runs": plain_walls,
          "unsharded_step_ms": plain_ms,
          "sharded_over_unsharded": step_ms / plain_ms,
          "bit_equal_twice": True, "loss": loss0,
          "peak_device_bytes": peak,
          "device_busy_ms": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "device_kernels": prof["device_kernels"], "traces": prof["traces"],
          "model_flop_share_of_bf16_peak":
              roofline.flop_share(cfg, shape, step_ms / 1e3)})

    # the float32 twin (TF32 off) at full depth against the unsharded step
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    shape32 = ShapeConfig("train", SHARD_F32["seq"], SHARD_F32["batch"],
                          "train")
    tcfg32 = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    p32 = tree.map_(lambda x: x.detach(),
                    LM(cfg32, device=dev, seed=0).params())
    b32 = {k: v[:SHARD_F32["batch"], :SHARD_F32["seq"]]
           for k, v in batch.items()}
    step, _, lay, ps, os_, bs = _sharded_train(cfg32, shape32, tcfg32, mesh,
                                            p32, b32)
    _zero_counts()
    got = step(ps, os_, bs)
    counts32 = _read_counts()
    impl32 = fa_ops.bwd_impl_for(torch.float32, cfg32.resolved_head_dim)
    want32 = bwd_expected(n_sh * cfg32.n_layers, impl32)
    check(counts32["flash_bwd"] == want32,
          f"{tag}: float32 gradient launches {counts32['flash_bwd']} in a "
          f"step on {n_sh} shards, expected {want32} ({impl32})")
    got_p = shd.gather_tree(got[0], lay["params"], mesh)
    got_o = shd.gather_tree(got[1], lay["opt"], mesh)
    got_loss = got[2]["loss"].item()
    del step, ps, os_, bs, got
    plain, opt0 = _plain_train(cfg32, shape32, tcfg32, dev, p32)
    want = plain(p32, opt0, b32)
    loss_rel = abs(got_loss - want[2]["loss"].item()) / abs(
        want[2]["loss"].item())
    param_err = _max_abs(got_p, want[0])
    grad_rel = _max_rel(tree.leaves(got_o["m"]), tree.leaves(want[1]["m"]))
    v_rel = _max_rel(tree.leaves(got_o["v"]), tree.leaves(want[1]["v"]))
    adam_ratio, adam_excess, adam_worst = _adam_ratio(
        got_p, want[0], p32, got_o, want[1], want[2]["lr"].item(), tcfg32)
    check(loss_rel <= SHARD_LOSS_RTOL, f"{tag}: float32 sharded loss "
          f"{got_loss} vs unsharded {want[2]['loss'].item()}")
    check(grad_rel <= SHARD_GRAD_REL, f"{tag}: float32 sharded AdamW m "
          f"{grad_rel} of its max from the unsharded step's")
    check(v_rel <= SHARD_GRAD_REL, f"{tag}: float32 sharded AdamW v "
          f"{v_rel} of its max from the unsharded step's")
    check(adam_ratio <= 1.0, f"{tag}: float32 sharded params {adam_ratio} x "
          "ADAM_BOUND from the unsharded step's")
    check(param_err <= SHARD_F32_PARAM_ATOL, f"{tag}: float32 sharded params "
          f"{param_err} from the unsharded step's")
    del plain, opt0, want, got_p, got_o
    gc.collect()
    torch.cuda.empty_cache()

    # prefill: bfloat16 (launches counted, error reported) and float32
    # (held to the bound)
    pshape = ShapeConfig("prefill", spec["seq"], spec["batch"], "prefill")
    pstep, pm = build_prefill_step(cfg, pshape, mesh, model=make_model(
        cfg, mesh=mesh, params=params))
    pl = pstep.layouts
    pps = shd.place_tree(params, pl["params"], mesh)
    tok = {"tokens": batch["tokens"]}
    pbs = shd.place_tree(tok, pl["batch"](tok), mesh)
    _zero_counts()
    (lgs, _), pre_ms = _sync_ms(lambda: pstep(pps, pbs))
    pcounts = _read_counts()
    check(pcounts["flash_attention"] == n_sh * cfg.n_layers and
          pcounts["flash_by_impl"]["wgmma"] == n_sh * cfg.n_layers,
          f"{tag}: {pcounts['flash_by_impl']} flash_attention launches in "
          f"the sharded prefill, expected {n_sh * cfg.n_layers}")
    lg = shd.gather_tree(lgs, [pl["logits"]], mesh)
    del lgs, pps
    plain_m = LM(cfg, device=dev, params=params)
    (ref, _), plain_pre_ms = _sync_ms(lambda: plain_m.prefill(tok))
    check(bool(torch.isfinite(lg).all()), f"{tag}: prefill logits")
    bf16_err = (lg - ref).abs().max().item()
    bf16_argmax = (lg.argmax(-1) == ref.argmax(-1)).float().mean().item()
    del plain_m, lg, ref
    gc.collect()
    torch.cuda.empty_cache()
    tok32 = {"tokens": b32["tokens"]}
    pstep32, _ = build_prefill_step(cfg32, ShapeConfig(
        "prefill", SHARD_F32["seq"], SHARD_F32["batch"], "prefill"), mesh,
        model=make_model(cfg32, mesh=mesh, params=p32))
    l32 = pstep32.layouts
    lg32 = shd.gather_tree(pstep32(shd.place_tree(p32, l32["params"], mesh),
                                   shd.place_tree(tok32, l32["batch"](tok32),
                                                  mesh))[0],
                           [l32["logits"]], mesh)
    ref32 = LM(cfg32, device=dev, params=p32).prefill(tok32)[0]
    f32_ratio = _f32_ratio(lg32, ref32)
    check(f32_ratio <= 1.0, f"{tag}: float32 sharded prefill logits "
          f"{f32_ratio} x the bound from the unsharded prefill's")
    emit({"phase": tag, "step": "twins", "f32_shape": SHARD_F32,
          "f32_loss_rel_err": loss_rel, "f32_loss_bound": SHARD_LOSS_RTOL,
          "f32_param_max_abs_err": param_err,
          "f32_param_atol": SHARD_F32_PARAM_ATOL,
          "f32_param_err_over_adam_bound": adam_ratio,
          "f32_param_rounding_share_of_r": adam_excess,
          "f32_adam_worst": adam_worst,
          "f32_m_max_rel_err": grad_rel, "f32_v_max_rel_err": v_rel,
          "f32_m_bound": SHARD_GRAD_REL,
          "f32_launches": {"flash_attention_bwd": counts32["flash_bwd"]},
          "f32_gradient_instance": impl32,
          "prefill_launches": {"flash_attention": pcounts["flash_attention"]},
          "prefill_collective_calls": pcounts["collectives"],
          "prefill_ms": pre_ms, "unsharded_prefill_ms": plain_pre_ms,
          "prefill_bf16_max_abs_err": bf16_err,
          "prefill_bf16_argmax_agree": bf16_argmax,
          "prefill_f32_err_over_bound": f32_ratio,
          "prefill_f32_bound": [SHARD_F32_ATOL, SHARD_F32_RTOL]})
    del p32, params, batch, lg32, ref32, pstep, pstep32, pm
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": {
        f"sharded_train_{spec['arch']}": counts["flash_attention"],
        f"sharded_prefill_{spec['arch']}": pcounts["flash_attention"]},
        "flash_attention_bwd": {f"sharded_train_{spec['arch']}":
                                sum(counts["flash_bwd"].values())},
        f"flash_attention_bwd_{impl32}": {
            f"sharded_train_{spec['arch']}_float32":
                sum(counts32["flash_bwd"].values())}}


def _aux_free(m):
    """The leaves of an LM tree that the MoE aux loss does not reach (its
    gradient flows into each router and all that feeds it): the last
    layer's experts, the final norm and the head, by name."""
    out = {f"embed.{k}": v for k, v in m["embed"].items()
           if k in ("final_norm", "head")}
    last = len(m["layers"]) - 1
    for k in ("w_gate", "w_up", "w_down"):
        out[f"layers.{last}.ffn.{k}"] = m["layers"][last]["ffn"][k]
    return out


def _moe_twins(cfg, mesh, shape, tcfg, dev, batch):
    """One sharded train step of ``cfg`` on ``mesh`` and the dense
    unsharded step from the same weights (seed 0) and batch: (counts of
    the sharded step, its dropped assignments, both steps' metrics, both
    steps' ms, both AdamW m of the leaves :func:`_aux_free` names, peak
    device bytes)."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.models import LM
    from repro_torch.train import tree
    torch.cuda.reset_peak_memory_stats()
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=dev, seed=0).params())
    step, model, lay, ps, os_, bs = _sharded_train(cfg, shape, tcfg, mesh,
                                                   params, batch)
    _zero_counts()
    model.moe_counts = counts_moe = []
    got, ms = _sync_ms(lambda: step(ps, os_, bs))
    model.moe_counts = None
    counts = _read_counts()
    dropped = sum(int(c[0]) for c in counts_moe)
    got_met = {k: v.item() for k, v in got[2].items()}
    got_m = _aux_free(shd.gather_tree([o["m"] for o in got[1]],
                                      lay["opt"]["m"], mesh))
    del got, step, model, ps, os_, bs
    gc.collect()
    torch.cuda.empty_cache()
    plain, opt0 = _plain_train(cfg, shape, tcfg, dev, params)
    want, plain_ms = _sync_ms(lambda: plain(params, opt0, batch))
    want_met = {k: v.item() for k, v in want[2].items()}
    want_m = _aux_free(want[1]["m"])
    peak = torch.cuda.max_memory_allocated()
    del plain, opt0, want, params
    gc.collect()
    torch.cuda.empty_cache()
    return (counts, dropped, got_met, want_met, ms, plain_ms, got_m, want_m,
            peak)


def _shard_moe(dev):
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.models import param as P
    from repro_torch.models.model import param_defs

    tag = "lm_sharded_moe"
    spec = SHARD_MOE
    full = get_config(spec["arch"])
    free = torch.cuda.mem_get_info()[0] - FIT_RESERVE_BYTES
    n = full.n_layers
    while n > 1 and SHARD_TRAIN_BYTES_PER_PARAM // 2 * P.bytes_of(
            param_defs(dataclasses.replace(full, n_layers=n))) > free:
        n -= 1
    cfg = _no_drop(dataclasses.replace(full, n_layers=n))
    mesh = _logical_mesh(dev, spec["mesh"])
    shape = ShapeConfig("train", spec["seq"], spec["batch"], "train")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=100, remat_policy="full")
    batch = to_device(SyntheticLMStream(cfg.vocab_size, spec["batch"],
                                        spec["seq"], seed=0).make_batch(0),
                      dev)
    rel = lambda a, b: abs(a - b) / abs(b)
    out = {}
    for dtype in (cfg.dtype, "float32"):
        c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        (counts, dropped, got_met, want_met, ms, plain_ms, got_m, want_m,
         peak) = _moe_twins(c, mesh, shape, tcfg, dev, batch)
        want_fa = mesh.size * cfg.n_layers * 2
        check(counts["flash_attention"] == want_fa, f"{tag} {dtype}: "
              f"{counts['flash_attention']} flash launches, expected "
              f"{want_fa}")
        check(dropped == 0, f"{tag} {dtype}: {dropped} assignments dropped")
        ce_rel = rel(got_met["ce"], want_met["ce"])
        gn_rel = rel(got_met["grad_norm"], want_met["grad_norm"])
        m_rel = {k: _max_rel([got_m[k]], [want_m[k]]) for k in want_m}
        del got_m, want_m
        f32 = dtype == "float32"
        ce_tol = SHARD_LOSS_RTOL if f32 else SHARD_MOE_CE_RTOL
        check(ce_rel <= ce_tol and gn_rel <= SHARD_MOE_GNORM_RTOL,
              f"{tag} {dtype}: sharded ce/grad norm {got_met} vs dense "
              f"{want_met}")
        if f32:
            check(max(m_rel.values()) <= SHARD_GRAD_REL, f"{tag} float32: "
                  f"sharded AdamW m {m_rel} of each leaf's largest from the "
                  "dense step's")
        out[dtype] = {
            "launches_per_step": {"flash_attention":
                                  counts["flash_attention"]},
            "collective_calls_per_step": counts["collectives"],
            "dropped": dropped, "sharded": got_met, "dense": want_met,
            "ce_rel_err": ce_rel, "ce_rtol": ce_tol,
            "grad_norm_rel_err": gn_rel,
            "grad_norm_rtol": SHARD_MOE_GNORM_RTOL,
            "m_rel_err_by_leaf": m_rel,
            "m_rel_bound": SHARD_GRAD_REL if f32 else None,
            "step_ms": ms, "dense_step_ms": plain_ms,
            "peak_device_bytes": peak}
    emit({"phase": tag, "step": "train", "arch": spec["arch"],
          "source": full.source,
          "mesh": dict(zip(("data", "model"), spec["mesh"])),
          "experts_per_shard": cfg.moe.n_experts // spec["mesh"][1],
          "seq": spec["seq"], "global_batch": spec["batch"],
          "reduced": {"n_layers": f"{full.n_layers} -> {n} (a train step "
                                  f"and its dense twin at "
                                  f"{SHARD_TRAIN_BYTES_PER_PARAM} bytes a "
                                  "param)",
                      "capacity_factor": f"{full.moe.capacity_factor} -> "
                                         f"{cfg.moe.capacity_factor} "
                                         "(no drop)"},
          "lr": TRAIN_LR, "by_dtype": out})
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": {
        f"sharded_train_{spec['arch']}":
        out[cfg.dtype]["launches_per_step"]["flash_attention"]}}


def _shard_rg(dev):
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.steps import build_decode_step, make_model
    from repro_torch.models import LM
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.train import tree

    tag = "lm_sharded_recurrentgemma"
    spec = SHARD_RG
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32")
    mesh = _logical_mesh(dev, spec["mesh"])
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=dev, seed=0).params())
    g = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (spec["batch"], spec["prompt"]
                                             + SHARD_DECODE), generator=g,
                         device=dev, dtype=torch.int32)
    dstep, model = build_decode_step(
        cfg, ShapeConfig("decode", spec["max_seq"], spec["batch"], "decode"),
        mesh, model=make_model(cfg, mesh=mesh, params=params))
    lay = dstep.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    head = {"tokens": toks[:, :spec["prompt"]]}
    widths = []
    orig = rglru_mod.rglru_ops.rglru_scan

    def scan(a, b, h0):
        widths.append(a.shape[-1])
        return orig(a, b, h0)

    _zero_counts()
    rglru_mod.rglru_ops.rglru_scan = scan
    try:
        (lgs, cs), pre_ms = _sync_ms(lambda: model.prefill(
            shd.place_tree(head, lay["batch"](head), mesh),
            max_seq=spec["max_seq"], params=ps))
    finally:
        rglru_mod.rglru_ops.rglru_scan = orig
    counts = _read_counts()
    n_rg = cfg.layer_kinds.count("rglru")
    n_fa = len(cfg.layer_kinds) - n_rg
    check(counts["rglru_scan"] == mesh.size * n_rg and
          set(widths) == {cfg.lru_width // spec["mesh"][1]},
          f"{tag}: rglru_scan {counts['rglru_scan']} launches at widths "
          f"{sorted(set(widths))}, expected {mesh.size * n_rg} at "
          f"{cfg.lru_width // spec['mesh'][1]}")
    check(counts["flash_attention"] == mesh.size * n_fa, f"{tag}: "
          f"{counts['flash_attention']} flash launches, expected "
          f"{mesh.size * n_fa}")
    plain = LM(cfg, device=dev, params=params)
    (ref, cache), plain_pre_ms = _sync_ms(lambda: plain.prefill(
        head, max_seq=spec["max_seq"]))
    ratios = [_f32_ratio(shd.gather_tree(lgs, [lay["logits"]], mesh), ref)]
    dec_ms, plain_dec_ms = [], []
    _zero_counts()
    for t in range(spec["prompt"], spec["prompt"] + SHARD_DECODE):
        b = {"tokens": toks[:, t:t + 1]}
        (lgs, cs), ms = _sync_ms(lambda: dstep(
            ps, shd.place_tree(b, lay["batch"](b), mesh), cs))
        (ref, cache), pms = _sync_ms(lambda: plain.decode_step(b, cache))
        dec_ms.append(ms)
        plain_dec_ms.append(pms)
        ratios.append(_f32_ratio(shd.gather_tree(lgs, [lay["logits"]], mesh),
                                 ref))
    dcounts = _read_counts()
    got_c = shd.gather_tree(cs, lay["cache"], mesh)
    cache_err = _max_abs(got_c, cache)
    check(max(ratios) <= 1.0, f"{tag}: sharded logits {ratios} x the bound "
          "from the unsharded model's")
    emit({"phase": tag, "step": "serve", "arch": spec["arch"],
          "mesh": dict(zip(("data", "model"), spec["mesh"])),
          "dtype": "float32", "prompt": spec["prompt"],
          "max_seq": spec["max_seq"], "batch": spec["batch"],
          "cache_spec_kv": list(lay["cache"]["layers"][2]["k"]),
          "prefill_launches": {"rglru_scan": counts["rglru_scan"],
                               "flash_attention": counts["flash_attention"]},
          "rglru_width_per_shard": sorted(set(widths)),
          "prefill_collective_calls": counts["collectives"],
          "decode_collective_calls_per_step":
              {k: v / SHARD_DECODE for k, v in dcounts["collectives"].items()},
          "logits_err_over_bound": ratios,
          "bound": [SHARD_F32_ATOL, SHARD_F32_RTOL],
          "cache_max_abs_err": cache_err, "prefill_ms": pre_ms,
          "unsharded_prefill_ms": plain_pre_ms, "decode_ms": dec_ms,
          "unsharded_decode_ms": plain_dec_ms})
    del plain, params, ps, cs, cache, got_c, model, dstep
    gc.collect()
    torch.cuda.empty_cache()
    return {"rglru_scan": {f"sharded_prefill_{spec['arch']}":
                           counts["rglru_scan"]},
            "flash_attention": {f"sharded_prefill_{spec['arch']}":
                                counts["flash_attention"]}}


def phase_lm_sharded(dev, readings):
    """Phase 11: the LM on meshes of logical shards of the card (the
    SHARD_* constants above); puts qwen3's loss into ``readings`` for
    phase 12; returns {kernel: {path: launches}}."""
    t0 = time.perf_counter()
    out = {}
    for part in (functools.partial(_shard_qwen, readings=readings),
                 _shard_moe, _shard_rg):
        for name, paths in part(dev).items():
            out.setdefault(name, {}).update(paths)
    emit({"phase": "lm_sharded", "step": "done",
          "seconds": time.perf_counter() - t0, "launches_by_path": out})
    return out


# The rest of model sharding (phase 12, ``phase_lm_sharded_more``), on
# (2, 4) meshes of logical shards of the card at published widths, in
# bfloat16, each case beside its unsharded twin: (a) recurrentgemma-2b,
# ``auto`` picking ``ctx`` (10 heads over 4): a train step at 2 x 2048
# (full remat; one flash launch a shard a local layer at offsets 0, 512,
# 1024 and 1536, twice), a prefill, SHARD_DECODE decode steps, and a
# float32 twin of the train step at 2 x SHARD_MORE_F32_SEQ (the scalar
# instance) held to the float32 bounds above; (b) rwkv6-1.6b cut to
# SHARD_MORE_RWKV_LAYERS layers: a train step at 2 x 2048 with RWKV_CHUNK
# and its float32 twin, a prefill and decode steps; (c) musicgen-medium
# (frames): a prefill, SHARD_MORE_DECODE decode steps and a train step; (d) internvl2-26b cut to SHARD_MORE_VLM_LAYERS layers, 256
# patches before the tokens: a prefill and a train step; (e) qwen3-0.6b
# with ``seq_parallel``: lm_sharded's train step (4 x 2048) against that
# phase's step on the same data, and a float32 twin at SHARD_F32's shape
# against the unsharded step; (f) recurrentgemma-2b with
# ``attn_sharding="heads"`` (every head on every shard): one prefill. A
# train step whose state would not fit runs at the depth SHARD_TRAIN_*
# allow (listed in the case's line). bf16 drift against the unsharded twin
# is reported, not held (PERF.md §7)
SHARD_MORE_RG = dict(arch="recurrentgemma-2b", mesh=(2, 4), seq=2048,
                     batch=2)
SHARD_MORE_RWKV = dict(arch="rwkv6-1.6b", mesh=(2, 4), seq=2048, batch=2)
# rwkv6 at this many of its 24 layers: its chunked wkv is plain torch
# (ROADMAP queue 1, item 16), and at all 24 the sharded train step took
# 53.3 s, its twin 11.0 s and the prefill 7.5 s on 8 shards, half the
# phase
SHARD_MORE_RWKV_LAYERS = 6
SHARD_MORE_MUSIC = dict(arch="musicgen-medium", mesh=(2, 4), seq=2048,
                        batch=2)
SHARD_MORE_VLM = dict(arch="internvl2-26b", mesh=(2, 4), seq=2048, batch=2)
SHARD_MORE_VLM_LAYERS = 2
SHARD_MORE_F32_SEQ = 512
# musicgen's decode steps (recurrentgemma's and rwkv6's: SHARD_DECODE)
SHARD_MORE_DECODE = 2
# a float32 twin holds params, grads, AdamW m and v, the new params and
# the new m and v (28 bytes a param), then the sharded results gathered
# whole beside the unsharded step's (12 more): 40
SHARD_TRAIN_F32_BYTES_PER_PARAM = 40


def _train_fit(cfg):
    """``cfg`` at the depth whose train step (SHARD_TRAIN_*_BYTES_PER_PARAM
    bytes a param) fits the card's free memory beside FIT_RESERVE_BYTES,
    in whole periods of its layer pattern; and the cut, for the line."""
    import dataclasses

    from repro_torch.models import param as P
    from repro_torch.models.model import param_defs
    per = (SHARD_TRAIN_F32_BYTES_PER_PARAM if cfg.param_dtype == "float32"
           else SHARD_TRAIN_BYTES_PER_PARAM)
    free = torch.cuda.mem_get_info()[0] - FIT_RESERVE_BYTES
    period = len(cfg.layer_pattern)
    n = cfg.n_layers
    while n > period and per * P.count(param_defs(
            dataclasses.replace(cfg, n_layers=n))) > free:
        n -= n % period or period
    cut = None if n == cfg.n_layers else (
        f"n_layers {cfg.n_layers} -> {n} (a train step at {per} bytes a "
        "param beside FIT_RESERVE_BYTES)")
    return dataclasses.replace(cfg, n_layers=n), cut


def _more_inputs(cfg, dev, B, S, seed, train):
    """Seeded inputs of S positions (``_family_inputs``), with targets
    for a train step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _family_inputs(cfg, g, dev, B, S)
    if train:
        n = S - (cfg.n_patches if cfg.frontend == "vlm" else 0)
        x["targets"] = torch.randint(0, cfg.vocab_size, (B, n), generator=g,
                                     device=dev, dtype=torch.int32)
    return x


def _more_train(tag, cfg, spec, perf, dev, *, tcfg=None, f32=False,
                profile_want=None, batch=None, param_atol=None):
    """One sharded train step of ``cfg`` on ``spec``'s mesh under ``perf``
    and the unsharded step from the same weights (seed 0) and batch: the
    line's readings. ``f32``: hold the float32 bounds (loss, AdamW m and v,
    ADAM_BOUND elementwise; the largest param gap reported, and held to
    ``param_atol`` where given); else report the drift."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.steps import build_train_step, make_model
    from repro_torch.models import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree

    t0 = time.perf_counter()
    secs = {}
    mesh = _logical_mesh(dev, spec["mesh"])
    B, S = spec["batch"], spec["seq"]
    shape = ShapeConfig("train", S, B, "train")
    tcfg = tcfg or TrainConfig(learning_rate=1e-3, warmup_steps=2,
                               total_steps=10, remat_policy="full")
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=dev, seed=0).params())
    batch = batch or _more_inputs(cfg, dev, B, S, 1, True)
    torch.cuda.reset_peak_memory_stats()
    step, _, lay, ps, os_, bs = _sharded_train(cfg, shape, tcfg, mesh,
                                               params, batch, perf)
    secs["set_up"] = time.perf_counter() - t0
    _zero_counts()
    got, ms = _sync_ms(lambda: step(ps, os_, bs))
    counts = _read_counts()
    check(all(bool(torch.isfinite(v).all()) for v in got[2].values()),
          f"{tag}: metrics not finite {got[2]}")
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    got_met = {k: v.item() for k, v in got[2].items()}
    prof = None
    if profile_want:
        del got
        prof = _profile_step(lambda: step(ps, os_, bs), tag, profile_want)
    secs["profile"] = time.perf_counter() - t1
    del step, ps, os_, bs
    gc.collect()
    torch.cuda.empty_cache()
    if f32:
        got_p = shd.gather_tree(got[0], lay["params"], mesh)
        got_o = shd.gather_tree(got[1], lay["opt"], mesh)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    plain, _ = build_train_step(cfg, shape, tcfg, dev, model=make_model(
        cfg, perf, None, device=dev, params=params))
    opt0 = opt.init(params)
    t1 = time.perf_counter()
    want, plain_ms = _sync_ms(lambda: plain(params, opt0, batch))
    want_met = {k: v.item() for k, v in want[2].items()}
    secs["unsharded"] = time.perf_counter() - t1
    out = {"step_ms": ms, "unsharded_step_ms": plain_ms,
           "sharded_over_unsharded": ms / plain_ms,
           "launches_per_step": {
               "flash_attention": counts["flash_attention"],
               "flash_by_impl": counts["flash_by_impl"],
               "flash_by_offset": counts["flash_by_offset"],
               "flash_bwd": counts["flash_bwd"],
               "rglru_scan": counts["rglru_scan"]},
           "collective_calls_per_step": counts["collectives"],
           "peak_device_bytes": peak, "sharded": got_met,
           "unsharded": want_met,
           "loss_rel_err": abs(got_met["loss"] - want_met["loss"])
           / abs(want_met["loss"])}
    if prof is not None:
        out.update(device_busy_ms=prof["device_busy_ms"],
                   device_idle_share=prof["device_idle_share"],
                   device_kernels=prof["device_kernels"],
                   traces=prof["traces"],
                   traced={k: v["launches"] for k, v in
                           prof["traced"].items()})
    if f32:
        grad_rel = _max_rel(tree.leaves(got_o["m"]),
                            tree.leaves(want[1]["m"]))
        v_rel = _max_rel(tree.leaves(got_o["v"]), tree.leaves(want[1]["v"]))
        param_err = _max_abs(got_p, want[0])
        adam_ratio, adam_excess, adam_worst = _adam_ratio(
            got_p, want[0], params, got_o, want[1], want_met["lr"], tcfg)
        check(out["loss_rel_err"] <= SHARD_LOSS_RTOL, f"{tag}: float32 "
              f"sharded loss {got_met['loss']} vs unsharded "
              f"{want_met['loss']}")
        check(grad_rel <= SHARD_GRAD_REL, f"{tag}: float32 sharded AdamW m "
              f"{grad_rel} of its max from the unsharded step's")
        check(v_rel <= SHARD_GRAD_REL, f"{tag}: float32 sharded AdamW v "
              f"{v_rel} of its max from the unsharded step's")
        check(adam_ratio <= 1.0, f"{tag}: float32 sharded params "
              f"{adam_ratio} x ADAM_BOUND from the unsharded step's")
        check(param_atol is None or param_err <= param_atol, f"{tag}: "
              f"float32 sharded params {param_err} from the unsharded "
              "step's")
        out.update(loss_bound=SHARD_LOSS_RTOL, m_max_rel_err=grad_rel,
                   v_max_rel_err=v_rel, m_bound=SHARD_GRAD_REL, param_max_abs_err=param_err,
                   param_atol=param_atol,
                   param_err_over_adam_bound=adam_ratio,
                   param_rounding_share_of_r=adam_excess,
                   adam_worst=adam_worst)
        del got_p, got_o
    del plain, opt0, want, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = dict(secs, total=time.perf_counter() - t0)
    return out


def _ctx_shares(durations, mesh, n_layers):
    """Each model index's share of the flash kernels' device time in a
    traced prefill, whose launches run in shard order layer by layer
    (None unless the trace holds every launch)."""
    if len(durations) != mesh.size * n_layers:
        return None
    by_j = {}
    for k, us in enumerate(durations):
        j = mesh.axis_index(k % mesh.size, "model")
        by_j[j] = by_j.get(j, 0.0) + us
    total = sum(by_j.values())
    return {str(j): by_j[j] / total for j in sorted(by_j)}


def _flash_durations(fn, tries=3):
    """Per try, the flash (wgmma) kernels' device microseconds in launch
    order in one traced call."""
    from torch.autograd import DeviceType
    for _ in range(tries):
        with _trace() as prof:
            _sync_ms(fn)
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and FA_KERNELS["wgmma"][1] in e.name),
                     key=lambda e: e.time_range.start)
        yield [e.time_range.elapsed_us() for e in evs]


def _more_serve(tag, cfg, spec, perf, dev, *, decode=SHARD_DECODE,
                shares=False):
    """A sharded prefill of ``spec``'s batch (and ``decode`` decode steps)
    against the unsharded model's from the same weights (seed 0): the
    line's readings and the prefill's flash launches. ``shares``: each
    model index's share of the prefill's flash device time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.steps import build_decode_step, make_model
    from repro_torch.models import LM
    from repro_torch.train import tree

    mesh = _logical_mesh(dev, spec["mesh"])
    B, S = spec["batch"], spec["seq"]
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=dev, seed=0).params())
    x = _more_inputs(cfg, dev, B, S + decode, 2, False)
    key = _seq_key(cfg)
    n_in = x[key].shape[1]
    head = {k: v if k == "patches" else v[:, :n_in - decode]
            for k, v in x.items()}
    max_seq = S + decode
    dstep, model = build_decode_step(
        cfg, ShapeConfig("decode", max_seq, B, "decode"), mesh, perf,
        model=make_model(cfg, perf, mesh, params=params))
    lay = dstep.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    hb = shd.place_tree(head, lay["batch"](head), mesh)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    (lgs, cs), pre_ms = _sync_ms(lambda: model.prefill(
        hb, max_seq=max_seq, params=ps))
    counts = _read_counts()
    lg = shd.gather_tree(lgs, [lay["logits"]], mesh)
    check(bool(torch.isfinite(lg).all()), f"{tag}: prefill logits")
    out = {"prefill_ms": pre_ms,
           "prefill_launches": {
               "flash_attention": counts["flash_attention"],
               "flash_by_impl": counts["flash_by_impl"],
               "flash_by_offset": counts["flash_by_offset"],
               "rglru_scan": counts["rglru_scan"]},
           "prefill_collective_calls": counts["collectives"]}
    if shares:
        n_fa = sum(k in ("global", "local") for k in cfg.layer_kinds)
        for durs in _flash_durations(lambda: model.prefill(
                hb, max_seq=max_seq, params=ps)):
            sh = _ctx_shares(durs, mesh, n_fa)
            if sh is not None:
                out["ctx_flash_share_by_model_index"] = sh
                out["ctx_flash_device_us"] = sum(durs)
                break
        check("ctx_flash_share_by_model_index" in out, f"{tag}: no trace "
              "of the prefill held every flash launch")
    del hb
    plain = LM(cfg, device=dev, params=params, rwkv_chunk=perf.rwkv_chunk)
    (want, cache), plain_pre_ms = _sync_ms(lambda: plain.prefill(
        head, max_seq=max_seq))
    errs = [(lg - want).abs().max().item()]
    out["unsharded_prefill_ms"] = plain_pre_ms
    out["prefill_argmax_agree"] = (lg.argmax(-1) == want.argmax(-1)).float(
        ).mean().item()
    dec_ms, plain_dec_ms = [], []
    _zero_counts()
    for t in range(decode):
        j = n_in - decode + t
        b = {key: x[key][:, j:j + 1]}
        (lgs, cs), ms = _sync_ms(lambda: dstep(
            ps, shd.place_tree(b, lay["batch"](b), mesh), cs))
        (want, cache), pms = _sync_ms(lambda: plain.decode_step(b, cache))
        dec_ms.append(ms)
        plain_dec_ms.append(pms)
        lg = shd.gather_tree(lgs, [lay["logits"]], mesh)
        check(bool(torch.isfinite(lg).all()), f"{tag}: decode logits")
        errs.append((lg - want).abs().max().item())
    if decode:
        dcounts = _read_counts()
        out.update(decode_ms=dec_ms, unsharded_decode_ms=plain_dec_ms,
                   decode_collective_calls_per_step={
                       k: v / decode for k, v in
                       dcounts["collectives"].items()},
                   cache_max_abs_err=_max_abs(
                       shd.gather_tree(cs, lay["cache"], mesh), cache))
    out.update(logits_max_abs_err_by_step=errs,
               peak_device_bytes=torch.cuda.max_memory_allocated())
    del plain, params, ps, cs, cache, model, dstep, lg, lgs, want, x
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts["flash_attention"]


def phase_lm_sharded_more(dev, readings):
    """Phase 12: the rest of model sharding on logical shards of the card
    (the comment above SHARD_MORE_RG); one line a step of each case;
    ``readings``: phase 11's (qwen3's loss, for (e)); returns {kernel:
    {path: launches}}."""
    import dataclasses

    from repro_torch.configs.base import ShardingConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model import attn_mode

    t0 = time.perf_counter()
    fa, rg_paths, bwd_fma = {}, {}, {}
    n_sh = 8

    def n_attn(cfg):
        return sum(k in ("global", "local") for k in cfg.layer_kinds)

    def line(tag, step, spec, cfg, **kw):
        emit({"phase": tag, "step": step, "arch": spec["arch"],
              "mesh": dict(zip(("data", "model"), spec["mesh"])),
              "dtype": cfg.dtype, "seq": spec["seq"],
              "global_batch": spec["batch"], **kw})

    # (a) recurrentgemma-2b, auto -> ctx
    tag = "lm_sharded_more_ctx"
    spec = SHARD_MORE_RG
    m = spec["mesh"][1]
    full = get_config(spec["arch"])
    perf = ShardingConfig()
    mode = attn_mode(full, perf, m)
    check(mode == "ctx", f"recurrentgemma-2b on model={m}: auto gave {mode}")
    qc = spec["seq"] // m
    cfg, cut = _train_fit(full)
    per_step = n_sh * n_attn(cfg) * 2
    train = _more_train(tag, cfg, spec, perf, dev,
                        profile_want={FA_KERNELS["wgmma"][1]: per_step})
    lps = train["launches_per_step"]
    want_by = {str(j * qc): per_step // m for j in range(m)}
    check(lps["flash_attention"] == per_step and
          lps["flash_by_impl"] == {"wgmma": per_step, "scalar": 0} and
          lps["flash_by_offset"] == want_by,
          f"{tag}: train flash launches {lps}, expected {per_step} on "
          f"wgmma at offsets {want_by}")
    line(tag, "train", spec, cfg, attn_sharding="auto", attn_mode=mode,
         heads=full.n_heads, q_rows_per_shard=qc, n_layers=cfg.n_layers,
         reduced=cut, **train)
    fa[f"sharded_more_train_{spec['arch']}_ctx"] = lps["flash_attention"]
    rg_paths[f"sharded_more_train_{spec['arch']}_ctx"] = lps["rglru_scan"]
    serve, n_pre = _more_serve(tag, full, spec, perf, dev, shares=True)
    want_pre = {str(j * qc): n_sh * n_attn(full) // m for j in range(m)}
    check(n_pre == n_sh * n_attn(full) and
          serve["prefill_launches"]["flash_by_offset"] == want_pre,
          f"{tag}: prefill flash launches {serve['prefill_launches']}, "
          f"expected {want_pre}")
    line(tag, "serve", spec, full, **serve)
    fa[f"sharded_more_prefill_{spec['arch']}_ctx"] = n_pre
    rg_paths[f"sharded_more_prefill_{spec['arch']}_ctx"] = \
        serve["prefill_launches"]["rglru_scan"]
    cfg32, cut32 = _train_fit(dataclasses.replace(
        full, dtype="float32", param_dtype="float32"))
    spec32 = dict(spec, seq=SHARD_MORE_F32_SEQ)
    twin = _more_train(tag + "_f32", cfg32, spec32, perf, dev, f32=True)
    tl = twin["launches_per_step"]
    check(tl["flash_by_impl"]["scalar"] == tl["flash_attention"] > 0,
          f"{tag}_f32: flash launches {tl}")
    # its head dim (256) is above the tf32 instance's: the FMA kernels
    n_bwd = tl["flash_bwd"]["dkdv_sum"]
    check(fa_ops.bwd_impl_for(torch.float32, cfg32.resolved_head_dim)
          == "fma" and n_bwd > 0
          and tl["flash_bwd"] == bwd_expected(n_bwd, "fma"),
          f"{tag}_f32: gradient launches {tl['flash_bwd']}, expected the "
          "FMA instance's")
    bwd_fma[f"sharded_more_train_{spec['arch']}_float32"] = 4 * n_bwd
    line(tag, "f32_twin", spec32, cfg32, n_layers=cfg32.n_layers,
         reduced=cut32, **twin)

    # (b) rwkv6-1.6b
    tag = "lm_sharded_more_rwkv"
    spec = SHARD_MORE_RWKV
    full = get_config(spec["arch"])
    perf = ShardingConfig(rwkv_chunk=RWKV_CHUNK)
    heads = full.d_model // full.rwkv_head_dim // spec["mesh"][1]
    cut = (f"n_layers {full.n_layers} -> {SHARD_MORE_RWKV_LAYERS} "
           "(time: the plain-torch chunked wkv on 8 shards)")
    cfg = dataclasses.replace(full, n_layers=SHARD_MORE_RWKV_LAYERS)
    train = _more_train(tag, cfg, spec, perf, dev)
    line(tag, "train", spec, cfg, rwkv_chunk=RWKV_CHUNK,
         heads_per_shard=heads, n_layers=cfg.n_layers, reduced=cut, **train)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    spec32 = dict(spec, seq=SHARD_MORE_F32_SEQ)
    twin = _more_train(tag + "_f32", cfg32, spec32, perf, dev, f32=True)
    line(tag, "f32_twin", spec32, cfg32, n_layers=cfg32.n_layers,
         reduced=cut, **twin)
    serve, _ = _more_serve(tag, cfg, spec, perf, dev)
    line(tag, "serve", spec, cfg, rwkv_chunk=RWKV_CHUNK, reduced=cut,
         **serve)

    # (c) musicgen-medium, frames
    tag = "lm_sharded_more_music"
    spec = SHARD_MORE_MUSIC
    full = get_config(spec["arch"])
    perf = ShardingConfig()
    serve, n_pre = _more_serve(tag, full, spec, perf, dev,
                               decode=SHARD_MORE_DECODE)
    check(n_pre == n_sh * n_attn(full), f"{tag}: {n_pre} prefill flash "
          f"launches, expected {n_sh * n_attn(full)}")
    line(tag, "serve", spec, full, frontend=full.frontend, **serve)
    fa[f"sharded_more_prefill_{spec['arch']}"] = n_pre
    cfg, cut = _train_fit(full)
    train = _more_train(tag, cfg, spec, perf, dev)
    line(tag, "train", spec, cfg, n_layers=cfg.n_layers, reduced=cut,
         **train)
    fa[f"sharded_more_train_{spec['arch']}"] = \
        train["launches_per_step"]["flash_attention"]

    # (d) internvl2-26b, its first SHARD_MORE_VLM_LAYERS layers
    tag = "lm_sharded_more_vlm"
    spec = SHARD_MORE_VLM
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=SHARD_MORE_VLM_LAYERS)
    cut = f"n_layers {full.n_layers} -> {SHARD_MORE_VLM_LAYERS}"
    serve, n_pre = _more_serve(tag, cfg, spec, perf, dev, decode=0)
    check(n_pre == n_sh * n_attn(cfg), f"{tag}: {n_pre} prefill flash "
          f"launches, expected {n_sh * n_attn(cfg)}")
    line(tag, "serve", spec, cfg, frontend=full.frontend,
         patches=full.n_patches, reduced=cut, **serve)
    fa[f"sharded_more_prefill_{spec['arch']}"] = n_pre
    train = _more_train(tag, cfg, spec, perf, dev)
    line(tag, "train", spec, cfg, reduced=cut, **train)
    fa[f"sharded_more_train_{spec['arch']}"] = \
        train["launches_per_step"]["flash_attention"]

    # (e) qwen3-0.6b with seq_parallel
    tag = "lm_sharded_more_sp"
    spec = SHARD_QWEN
    cfg = get_config(spec["arch"])
    perf = ShardingConfig(seq_parallel=True)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=100, remat_policy="full")
    batch = to_device(SyntheticLMStream(cfg.vocab_size, spec["batch"],
                                        spec["seq"], seed=0).make_batch(0),
                      dev)
    train = _more_train(tag, cfg, spec, perf, dev, tcfg=tcfg, batch=batch)
    check(train["collective_calls_per_step"]["reduce_scatter"] > 0,
          f"{tag}: no reduce_scatter in a seq_parallel step "
          f"{train['collective_calls_per_step']}")
    non_sp = readings["qwen3_loss"]
    line(tag, "train", spec, cfg, seq_parallel=True,
         lm_sharded_loss=non_sp,
         loss_vs_lm_sharded_rel=abs(train["sharded"]["loss"] - non_sp)
         / abs(non_sp),
         loss_bits_equal_lm_sharded=train["sharded"]["loss"] == non_sp,
         **train)
    fa[f"sharded_more_train_{spec['arch']}_sp"] = \
        train["launches_per_step"]["flash_attention"]
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    b32 = {k: v[:SHARD_F32["batch"], :SHARD_F32["seq"]]
           for k, v in batch.items()}
    spec32 = dict(spec, **SHARD_F32)
    twin = _more_train(tag + "_f32", cfg32, spec32, perf, dev, f32=True,
                       batch=b32, param_atol=SHARD_F32_PARAM_ATOL)
    line(tag, "f32_twin", spec32, cfg32, seq_parallel=True, **twin)
    del batch, b32

    # (f) recurrentgemma-2b, heads whole on every shard
    tag = "lm_sharded_more_heads"
    spec = SHARD_MORE_RG
    full = get_config(spec["arch"])
    perf = ShardingConfig(attn_sharding="heads")
    serve, n_pre = _more_serve(tag, full, spec, perf, dev, decode=0)
    check(n_pre == n_sh * n_attn(full) and
          serve["prefill_launches"]["flash_by_offset"] == {"0": n_pre},
          f"{tag}: prefill flash launches {serve['prefill_launches']}")
    line(tag, "serve", spec, full, attn_sharding="heads",
         heads=full.n_heads, **serve)
    fa[f"sharded_more_prefill_{spec['arch']}_heads"] = n_pre
    emit({"phase": "lm_sharded_more", "step": "done",
          "seconds": time.perf_counter() - t0,
          "launches_by_path": {"flash_attention": fa,
                               "rglru_scan": rg_paths}})
    return {"flash_attention": fa, "rglru_scan": rg_paths,
            "flash_attention_bwd_fma": bwd_fma}


# The LM families' phases and the LM training phases each run in a child
# process of this script (``--families``, ``--train``), which the parent
# waits for: in the script's own process, after the families' phases,
# three runs each traced 51 of the 52 rglru_scan launches of
# recurrentgemma-2b's train step in every retry (the counters showed 52),
# while the phase alone in a fresh process traced all 52; and one run, on a
# slow host, traced 17 of the 18 rglru_scan launches of recurrentgemma-2b's
# prefill in every retry after the decision loop's phases (PERF.md §7). A
# child's lines pass through; its last line gives its launches.
CHILD_TIMEOUT_S = 700


# the flash gradient at qwen3-0.6b's heads and its 32,768-token context
# (the reference's prefill_32k length), batch 1, bfloat16: the kernels'
# device memory above their inputs must stay under this (reckoned: dq, dk,
# dv and delta come to ~0.27 GB, the float32 shares of dK and dV of the 16
# q heads to 0.54 GB; one float32 (S, S) score tensor of the plain
# recompute the gradient kernel replaced is 68.7 GB)
BWD_32K = dict(S=32768, H=16, Hkv=8, D=128)
BWD_32K_PEAK = 1 << 30


def phase_flash_bwd_32k(dev):
    """The gradient's wgmma instance at BWD_32K: device memory above the
    inputs (under BWD_32K_PEAK), its time (a CUDA event pair around the
    one call: the kernels are built, and at tens of ms a call launch
    overhead is nothing), the chunked plain backward's time (one call,
    host clock) and peak, and the kernels' gradients held to the plain one
    within ``ref.backward_error_bound(same_stats=True, split=True)``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_ref, backward_error_bound)

    tag = "flash_bwd_32k"
    S, H, HKV, D = (BWD_32K[k] for k in ("S", "H", "Hkv", "D"))
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(6)
    q = (torch.randn((1, S, H, D), generator=g, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    k, v = (torch.randn((1, S, HKV, D), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    dout = torch.randn((1, S, H, D), generator=g, device=dev).to(
        torch.bfloat16)
    lse = torch.empty((1, H, S), dtype=torch.float32, device=dev)
    out = fa_ops.flash_attention(q, k, v, scale=1.0, lse=lse)
    args = (q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    got = fa_ops.flash_attention_backward(*args, scale=1.0)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    bwd_launches_check(tag, before)
    peak_above = torch.cuda.max_memory_allocated() - base
    check(peak_above < BWD_32K_PEAK, f"{tag}: {peak_above} bytes above the "
          f"inputs, expected under {BWD_32K_PEAK}")
    torch.cuda.reset_peak_memory_stats()
    want, plain_ms = _sync_ms(
        lambda: attention_backward_ref(*args, scale=1.0))
    plain_peak = torch.cuda.max_memory_allocated() - base
    bounds = backward_error_bound(*args, scale=1.0, same_stats=True,
                                  split=True, ref=want)
    ratio = _bwd_ratio(got, want, bounds)
    del bounds
    check(ratio <= 1.0, f"{tag}: gradients {ratio} x the bound from the "
          "plain backward")
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    check(finite, f"{tag}: gradients not finite")
    pairs = S * (S + 1) // 2
    emit({"phase": tag, "shape": [1, S, H, D], "kv_heads": HKV,
          "dtype": "bfloat16", "ms": ms,
          "plain_ms_host": plain_ms, "peak_bytes_above_inputs": peak_above,
          "peak_bound_bytes": BWD_32K_PEAK,
          "plain_peak_bytes_above_inputs": plain_peak,
          "err_over_bound": ratio,
          "max_abs_err": max((a.float() - b.float()).abs().max().item()
                             for a, b in zip(got, want)),
          "achieved_tflops": 2.5 * 4 * H * D * pairs / (ms * 1e-3)
          / 1e12})
    del q, k, v, dout, lse, out, args, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": sum(bwd_expected().values())}


def run_train_phases(dev):
    """The LM training phases; returns {kernel: {path: launches}}."""
    by_path = {}
    for name, n in phase_flash_bwd_32k(dev).items():
        by_path.setdefault(name, {})["flash_bwd_32k"] = n
    for arch, phase in ((TRAIN["arch"], phase_lm_train),
                        (TRAIN_RG["arch"], phase_lm_train_rglru)):
        for name, n in phase(dev).items():
            by_path.setdefault(name, {})[f"train_{arch}"] = n
    readings = {}
    for phase in (phase_lm_sharded, phase_lm_sharded_more):
        for name, paths in phase(dev, readings).items():
            by_path.setdefault(name, {}).update(paths)
    return by_path


def run_family_phases(dev):
    """The LM families' phases; returns {kernel: {path: launches}}."""
    by_path = {}
    for arch in FAMILIES:
        for name, n in phase_lm_family(dev, arch).items():
            if n:
                by_path.setdefault(name, {})[f"lm_{arch}"] = n
    return by_path


CHILD_PHASES = {"--families": run_family_phases, "--train": run_train_phases}


def in_child(flag):
    """The phases of ``flag`` (CHILD_PHASES) in a child process on the same
    card, the parent's cached device memory released first; returns their
    launches."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), flag,
         str(time.perf_counter() - T_START)],
        stdout=subprocess.PIPE, text=True, timeout=CHILD_TIMEOUT_S)
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"child_launches"'):
            launches = json.loads(line)["child_launches"]
        else:
            print(line, flush=True)
    check(proc.returncode == 0 and launches is not None,
          f"the {flag[2:]} phases' process exited {proc.returncode}")
    return launches


def child_main(flag, offset_s: float) -> None:
    """The child of in_child: its phase lines' ``at_s`` go on from the
    parent's ``offset_s``; it ends its process itself."""
    global T_START
    T_START -= offset_s
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    print(json.dumps({"child_launches": CHILD_PHASES[flag](
        torch.device("cuda"))}), flush=True)
    # the parent waits for this process to end: skip the interpreter's
    # teardown of the phases' objects and the card's memory (the script's
    # last ~20 s went between the training child's last line and the end)
    os._exit(0)


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

    at_path, at_lm, at_case = phase_kernels(dev)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        launches, raw, scan_ref = phase_scan(dev, tmp)
        launches["harmonize"] = phase_harmonize(raw)
        week = phase_harmonize_week(dev)
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
    f16 = phase_lm_float16(dev)
    by_path["flash_attention"][f"lm_{LM_ARCH}_float16"] = sum(f16.values())
    by_path["harmonize"]["harmonize_op_week"] = week
    by_instance = {
        "flash_attention_f16": {f"lm_{LM_ARCH}_float16": f16["wgmma"]},
        "flash_attention_scalar": {f"lm_{LM_ARCH}_float16_twin":
                                   f16["scalar"]},
        "harmonize_tiled": {"harmonize_op_week": week}}
    for flag in CHILD_PHASES:
        for name, paths in in_child(flag).items():
            by_path.setdefault(name, {}).update(paths)
    for name in ("flash_attention_bwd_tf32", "flash_attention_bwd_fma"):
        by_instance[name] = by_path.pop(name)
    emit({"phase": "children_done"})

    def entry(name, t, source, replaces, paths, **extra):
        us = {f"{k[:-3]}_us": (None if t[k] is None else t[k] * 1e3)
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        us["us"] = us.pop("_us")
        return dict(name=name, route="cuda", parity="ok", source=source,
                    replaces=replaces, launches=sum(paths.values()),
                    launches_by_path=paths, **t, **us, **extra)

    kernels = [entry(name, at_path[name], *KERNEL_META[name], by_path[name],
                     **({"at_lm_shape": at_lm[name]} if name in at_lm
                        else {}),
                     **({"at_train_rg": at_case[(name, "train_rg")]}
                        if (name, "train_rg") in at_case else {}))
               for name in KERNEL_META]
    for name, (kernel, case, instance, source) in INSTANCE_ENTRIES.items():
        kernels.append(entry(name, at_case[(kernel, case)], source,
                             KERNEL_META[kernel][1], by_instance[name],
                             kernel=kernel, instance=instance, case=case))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in CHILD_PHASES:
        child_main(sys.argv[1], float(sys.argv[2]))
    sys.exit(main())
