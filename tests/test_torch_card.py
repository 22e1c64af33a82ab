"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no card is present (the kernels
have no CPU mode; their plain versions are held against the JAX package by
``test_torch_kernels.py``). This file imports neither ``jax`` nor
``repro``, so it runs on a machine with the card and PyTorch alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_card.py``.

Tolerances: exact for selection (LOCF, min/max/last), counts, masks and
the recurrence (the kernel writes no FMA, the plain version has none);
rtol = atol = 1e-5 for window mean/var/sum, which add in another order.
locf and window_agg run each of their instances (``row`` at T <= 16,
``warp`` above; asserted through ``LAUNCHES_BY_IMPL``), aligned and at an
offset of one element; the row instance of window_agg adds in the
sequential order, so its mean/var/sum equal a sequential float32 loop bit
for bit.
Harmonize: ``observed`` exact, means within atol 1e-5 / rtol 1e-4 (both
add the same values, the plain version in torch's reduction order). Both
of the kernel's instances (``warp`` up to ``MAX_T`` ticks, ``tiled``
above; asserted through ``LAUNCHES_BY_IMPL``) add in M order, so their
means are bit-equal to a sequential float32 loop, NaN positions included,
aligned and at an offset of one element, with NaN and +-inf in invalid,
out-of-range and hitting samples.
Flash attention (each case also asserts which kernel ran, through
``LAUNCHES_BY_IMPL``): max abs error 2e-3 in float32 (``tests/test_kernels.py``'s
bound): the kernel sums its products with FMAs in tile order and the plain
version through a matrix product. In bfloat16 one bfloat16 ulp of the
plain output, |out - ref| <= 2^-7 |ref| + 1e-5: both compute in float32
and round the output once (the wgmma kernel feeds PV with p split into
two halves of the input type), so they differ by at most one rounding
step (an absolute bound would be as large as the outputs of late rows,
which attend to many keys and so are small). In float16 two float16
ulps, 2^-9 |ref| + 1e-5: its ulp is 8x finer, and the kernel's tanhf
and expf and the plain version's torch.tanh and torch.exp differ in the
last float32 bits, which at softcapped scores in the tens moves p, and
the output before rounding, by ~1e-5 relative: one rounding step more
(one case of 63 read 1.06 x the one-ulp bound on an H100, a softcap of
50 over scores in the tens). Softcap cases scale q by 8, so that scores
reach tens and the cap changes the output far beyond the bound.
Every head dim runs a hand-written kernel, the one ``impl_for`` names
(``FA_ANY_D_CASES``, every dtype): bfloat16 and float16 at multiples of 8
up to 256 on the wgmma kernel's narrowest instance that holds them, the
rest (float32, D % 8 != 0, D > 256) on the scalar one, within the same
bounds.
At a query offset (a context-parallel shard's rows against every key) both
instances meet the same bounds against ``attention_ref`` at that offset,
and an offset launch's rows equal the same rows of one launch over every
position bit for bit where the offset is a multiple of the instance's q
block (the same tiles in the same order).
Determinism of the decision loop's host-free paths, bit for bit on the
card: ``harmonize_segment``'s scatter branch (M*T above the dense bound)
across two calls and between ``run_many`` and K ticks; ``add_batch``
against sequential ``add`` calls; ``run_many_decide`` against
``run_many`` + ``Predictor.on_windows``.
Elastic pools: ``run_many_decide`` gives E live rows inside a pool of W
slots the bits of a dense E-row run, on the card and, as the one group of
cases here that is not marked ``cuda``, on the CPU too (the contract
holds on both devices); the elastic trees, ``add_batch(env_mask=)``,
``harmonize_interp`` and ``detect_mad`` on the card equal the CPU bit for
bit.
Env sharding: ``run_many_decide`` on 1, 2, 4 and 8 logical shards of the
card gives every row the bits of the unsharded run (outputs, state, carry,
ring) with N times the kernel launches; with two cards, every wrapper
launches on its tensors' card and a mesh over both equals one card.
Online training on the card: the train step twice from the same inputs
and indices, bit for bit (no atomics in its backward); a step on an empty
ring returns its inputs' bits; ``mlp`` and ``rwkv6`` decide on the card
against the same call on the CPU, rtol = atol = 1e-5 (the repo's
single-module bound; the two devices round ``exp``, ``tanh`` and the
row sums differently).
The LM on a mesh of logical card shards: the (2, 4) ZeRO-3 train step of
qwen3 ``:smoke`` against the unsharded step on the card (loss rtol 1e-5,
params 1e-5, the CPU test's bounds) and twice bit for bit;
``moe_apply_sharded`` on the card against the CPU's shards (rtol = atol =
1e-5); the owner-local ``write_token`` against the unsharded write, bit for
bit.
Flash attention's gradient: the three instances of its four launches
(wgmma: bfloat16 and float16 at D % 8 == 0 up to 256; tf32: float32 and
the other 16-bit head dims up to 128, three TF32 products a product; FMA:
the head dims above), every dtype, head dims 20 to 320, G = 1 to 10,
windows, softcaps, offsets on and off the instances' blocks, against the
chunked plain backward from the same out and lse, within
``ref.backward_error_bound(same_stats=True)`` (the derived worst-case
float32 bound of two orders of the same sums, plus one rounding each to a
16-bit type; ``split=True`` for the wgmma instance, whose P and dS enter
its products as hi and lo halves of the type; ``split="tf32"`` for the
tf32 instance, whose every operand enters as TF32 big and small halves),
the instance ``bwd_impl_for`` names counted, two calls bit for bit; the
tf32 instance at the CPU emulation's shapes and at qwen3's heads in
float32 (1 x 2048), and a float32 head dim above its width on the FMA
kernels; both forward
kernels' logsumexp against the plain one within its derived bound, the
output's bytes unchanged by asking for it; and qwen3's heads at 32,768
tokens in bfloat16 under 1 GiB above the inputs.
LM training's autograd Functions on the card: ``FlashAttentionFn``'s
forward is the kernel (the flash bounds above against ``attention_ref``)
and its (dq, dk, dv) the gradient kernels (either instance), within
``ref.backward_error_bound`` of autograd through ``attention_ref`` (the
plain version recomputes its own statistics, and the wgmma forward's p
split and 16-bit output enter the bound); ``RGLRUScanFn``'s forward bit for bit against the plain
loop and its (da, db, dh0), one reversed launch of the kernel, against
autograd through the plain loop within 1e-6 of each gradient's largest
magnitude (the kernel adds g_t = dh_t + a_{t+1} g_{t+1} in the order
autograd accumulates it). A float32 train step repeated from the same
state and batch gives the same loss and params bit for bit, with the
kernels' launch counts of a ``full``-remat step.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.core import PipelineConfig
from repro_torch.core import harmonize as hz
from repro_torch.core import pipeline as pl
from repro_torch.core import replay as rp
from repro_torch.core.frame import RawWindow, make_raw_window
from repro_torch.core.harmonize import exact_div
from repro_torch.core.reward import energy_reward_spec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.harmonize import ops as hz_ops
from repro_torch.kernels.harmonize.ref import harmonize_ref
from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.locf.ref import locf_ref
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.rows import aligned
from repro_torch.kernels.window_agg import ops as wagg_ops
from repro_torch.kernels.window_agg.ref import window_agg_ref
from repro_torch.runtime import trainer as tr
from repro_torch.runtime.policies import PolicyConfig, build_policy
from repro_torch.runtime.predictor import ActionSpace, Predictor
from repro_torch.train import tree


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (test_torch_kernels.py holds their plain versions)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(card, rng):
    """Each CUDA kernel against its plain version on the same card tensors,
    with a launch counted per call."""
    C = lambda x: torch.from_numpy(np.array(x)).to(card)
    before = (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES)
    v = rng.normal(0, 1, (64, 8, 64)).astype(np.float32)
    o = rng.rand(64, 8, 64) > 0.6
    o[0, 0] = False
    iv = rng.normal(0, 1, (64, 8)).astype(np.float32)
    ih = rng.rand(64, 8) > 0.5
    out, has = locf_ops.locf(C(v), C(o), C(iv), C(ih))
    ref_v, ref_h = locf_ref(C(v).reshape(512, 64), C(o).reshape(512, 64),
                            C(iv).reshape(512), C(ih).reshape(512))
    assert torch.equal(has.reshape(512, 64), ref_h)
    assert torch.equal(out.reshape(512, 64)[ref_h], ref_v[ref_h])

    v = rng.normal(5, 2, (64, 8, 64)).astype(np.float32)
    m = rng.rand(64, 8, 64) > 0.3
    m[0, 0] = False
    mu = rng.normal(5, 1, (64, 8)).astype(np.float32)
    var = (np.abs(rng.normal(1, 0.3, (64, 8))) + 0.05).astype(np.float32)
    stats, spikes = wagg_ops.window_agg(C(v), C(m), C(mu), C(var))
    ref_s, ref_sp = window_agg_ref(C(v).reshape(512, 64),
                                   C(m).reshape(512, 64), C(mu).reshape(512),
                                   C(var).reshape(512), 6.0)
    stats = stats.reshape(512, 8)
    assert torch.equal(spikes.reshape(512, 64), ref_sp)
    assert torch.equal(stats[:, [2, 3, 4, 5, 7]], ref_s[:, [2, 3, 4, 5, 7]])
    torch.testing.assert_close(stats[:, [0, 1, 6]], ref_s[:, [0, 1, 6]],
                               rtol=1e-5, atol=1e-5)

    a = C(rng.uniform(0.5, 1.0, (64, 33, 48)).astype(np.float32))
    b = C(rng.normal(0, 1, (64, 33, 48)).astype(np.float32))
    h0 = C(rng.normal(0, 1, (64, 48)).astype(np.float32))
    hs, h = rglru_ops.rglru_scan(a, b, h0)
    ref_hs, ref_h = rglru_scan_ref(a, b, h0)
    assert torch.equal(hs, ref_hs) and torch.equal(h, ref_h)
    assert (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES) == \
        tuple(n + 1 for n in before)


# T: each row instance's edges (1, 16), odd and even T below 16, the
# path's 8; the warp instance at 17 (one chunk, mostly idle lanes), 32, the
# fleet's 64, 100 and 257 (partial chunks, odd T), and 2000 (more chunks
# than the window_agg kernel holds in registers)
ROW_TICKS = [1, 7, 8, 13, 16, 17, 32, 64, 100, 257, 2000]


def _rows(card, rng, T, offset, p):
    """(E, S) = (37, 3) rows, 111 of them (not a multiple of any block): each
    (E, S, T) input a contiguous view at storage offset ``offset``, so
    offset 1 leaves the data unaligned and takes the scalar loads. Row 0 has
    every tick flagged, row 1 none; the rest are flagged with chance p."""
    def C(x):
        flat = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(card)
        buf = torch.empty(flat.numel() + offset, dtype=flat.dtype,
                          device=card)
        buf[offset:] = flat
        return buf[offset:].view(x.shape)
    v = rng.normal(5, 2, (37, 3, T)).astype(np.float32)
    f = rng.rand(37, 3, T) < p
    f[0, 0], f[0, 1] = True, False
    return C, C(v), C(f)


def _expect_impl(ops, T, tensors, offset):
    """The instance and load width this launch must take, and the
    per-instance launch counts before it."""
    impl, vec = ops.impl_for(T, aligned(*tensors))
    assert impl == ("row" if T <= 16 else "warp")
    assert vec == (offset == 0 and T % (4 if impl == "row" else 2) == 0)
    return impl, dict(ops.LAUNCHES_BY_IMPL)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T", ROW_TICKS)
def test_locf_instances_on_card(card, rng, T, offset):
    """Both locf instances, bit-equal to the plain version where has is
    True (and where it is False: the carry-in value), with a carry-in-only
    row (nothing observed, init_has True) and an empty one."""
    C, v, o = _rows(card, rng, T, offset, 0.3)
    ih = rng.rand(37, 3) < 0.5
    ih[0, 1], ih[1, 0] = True, False
    o[1, 0] = False                       # empty, no carry: has stays False
    iv, ih = C(rng.normal(0, 1, (37, 3)).astype(np.float32)), C(ih)
    impl, by_impl = _expect_impl(locf_ops, T, (v, o), offset)
    out, has = locf_ops.locf(v, o, iv, ih)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert locf_ops.LAUNCHES_BY_IMPL == by_impl
    ref_v, ref_h = locf_ref(v.reshape(111, T), o.reshape(111, T),
                            iv.reshape(111), ih.reshape(111))
    out, has = out.reshape(111, T), has.reshape(111, T)
    assert torch.equal(has, ref_h)
    assert torch.equal(out, ref_v)
    assert has[1].all() and not has[3].any() and has[0].all()


def _sequential_stats(v, m):
    """mean, var, sum of each row as a sequential float32 loop over its
    ticks, one torch op at a time (so nothing is fused into an FMA)."""
    R, T = v.shape
    n = torch.zeros(R, device=v.device)
    s = torch.zeros(R, device=v.device)
    for t in range(T):
        s = torch.where(m[:, t], s + v[:, t], s)
        n = torch.where(m[:, t], n + 1, n)
    mean = s / n.clamp(min=1)
    ss = torch.zeros(R, device=v.device)
    for t in range(T):
        d = v[:, t] - mean
        ss = torch.where(m[:, t], ss + d * d, ss)
    return torch.stack([mean, ss / n.clamp(min=1), s], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("T", ROW_TICKS)
def test_window_agg_instances_on_card(card, rng, T, offset):
    """Both window_agg instances against the plain version: count, min,
    max, last, n_spikes and spikes equal, mean, var and sum within rtol =
    atol = 1e-5; rows all masked and all empty. The row instance (T <= 16)
    keeps the sequential order, so its mean, var and sum are bit-equal to a
    sequential float32 loop."""
    C, v, m = _rows(card, rng, T, offset, 0.7)
    mu = C(rng.normal(5, 1, (37, 3)).astype(np.float32))
    var = C((np.abs(rng.normal(1, 0.3, (37, 3))) + 0.05).astype(np.float32))
    impl, by_impl = _expect_impl(wagg_ops, T, (v, m, mu, var), offset)
    stats, spikes = wagg_ops.window_agg(v, m, mu, var, k_sigma=1.5)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert wagg_ops.LAUNCHES_BY_IMPL == by_impl
    v, m = v.reshape(111, T), m.reshape(111, T)
    ref_s, ref_sp = window_agg_ref(v, m, mu.reshape(111), var.reshape(111),
                                   1.5)
    stats = stats.reshape(111, 8)
    exact = [2, 3, 4, 5, 7]
    assert torch.equal(spikes.reshape(111, T), ref_sp)
    assert torch.equal(stats[:, exact], ref_s[:, exact])
    torch.testing.assert_close(stats[:, [0, 1, 6]], ref_s[:, [0, 1, 6]],
                               rtol=1e-5, atol=1e-5)
    assert stats[0, 5] == T and (stats[1] == 0).all()
    if impl == "row":
        assert torch.equal(stats[:, [0, 1, 6]], _sequential_stats(v, m))


# B, S, H, Hkv, D, window, softcap: ragged S, GQA/MQA/MHA, every head dim
# the kernels are built for, a window and a softcap; then S at, one below
# and one above the wgmma kernel's 128-row blocks, a long S, a window edge
# that cuts a key tile (100), and head dims 64 and 256 on longer rows
FA_CASES = [(2, 100, 4, 2, 64, 0, 0.0), (1, 128, 4, 4, 32, 48, 0.0),
            (1, 96, 2, 1, 128, 0, 50.0), (1, 70, 2, 1, 256, 0, 0.0),
            (2, 33, 4, 2, 16, 8, 30.0), (1, 300, 16, 8, 128, 0, 0.0),
            (1, 64, 2, 1, 128, 0, 0.0), (1, 127, 4, 2, 128, 0, 0.0),
            (2, 129, 4, 2, 128, 0, 0.0), (1, 1000, 4, 2, 128, 0, 0.0),
            (1, 2048, 4, 2, 128, 0, 0.0), (1, 500, 4, 2, 128, 100, 0.0),
            (1, 600, 4, 2, 64, 100, 50.0), (1, 520, 4, 2, 256, 100, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, "one ulp"),
                                       (torch.float16, "one ulp")])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,softcap", FA_CASES)
def test_flash_attention_matches_plain_on_card(card, rng, dtype, tol, B, S,
                                               H, Hkv, D, window, softcap):
    C = lambda scale, *shape: torch.from_numpy(
        rng.normal(0, scale, shape).astype(np.float32)).to(card, dtype)
    q = C(8 if softcap else 1, B, S, H, D)
    k, v = C(1, B, S, Hkv, D), C(1, B, S, Hkv, D)
    before = fa_ops.LAUNCHES
    impl = fa_ops.impl_for(dtype, D)
    by_impl = dict(fa_ops.LAUNCHES_BY_IMPL)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    by_impl[impl] += 1
    assert fa_ops.LAUNCHES_BY_IMPL == by_impl, (impl, by_impl)
    ref = attention_ref(q, k, v, window=window, softcap=softcap)
    assert out.dtype == dtype and out.shape == q.shape
    _flash_close(out, ref, dtype)
    if softcap:
        uncapped = attention_ref(q, k, v, window=window)
        assert (uncapped.float() - ref.float()).abs().max().item() > 0.1


# B, Sq, Skv, q_offset, H, Hkv, D, window, softcap: a context-parallel
# shard's rows at an offset against every key; Sq not a multiple of either
# kernel's q block (``fa_ops.Q_BLOCK``), offsets on and off a block
# edge, the last shard of an S % m != 0 split (Sq + offset = Skv), windows
# that start inside the shard, and a softcap
FA_OFFSET_CASES = [(2, 100, 400, 300, 4, 2, 64, 0, 0.0),
                   (1, 512, 2048, 1536, 4, 1, 128, 0, 0.0),
                   (1, 70, 300, 128, 4, 2, 128, 100, 0.0),
                   (1, 8, 30, 22, 2, 1, 128, 0, 0.0),
                   (2, 200, 600, 256, 4, 2, 256, 0, 50.0),
                   (1, 130, 520, 390, 4, 2, 256, 100, 50.0),
                   (1, 33, 97, 40, 4, 4, 64, 16, 30.0)]


def _flash_case(rng, card, dtype, B, Sq, Skv, H, Hkv, D, softcap):
    C = lambda scale, *shape: torch.from_numpy(
        rng.normal(0, scale, shape).astype(np.float32)).to(card, dtype)
    return (C(8 if softcap else 1, B, Sq, H, D), C(1, B, Skv, Hkv, D),
            C(1, B, Skv, Hkv, D))


# the 16-bit types' bounds, relative to the plain output: one bfloat16
# ulp; two float16 ulps (module docstring)
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9}


def _flash_close(out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    if dtype in ULP:
        bound = ULP[dtype] * ref.float().abs() + 1e-5
        assert (err <= bound).all(), (err / bound).max().item()
    else:
        assert err.max().item() <= 2e-3, err.max().item()


# B, S, H, Hkv, D, window, softcap at head dims off the instances' widths:
# below the narrowest (1, 8), inside wider ones (24, 36, 48, 72, 80, 96,
# 200), a multiple of 64 that is no wgmma instance (192), and above 256
# (300 and 320: the scalar kernel's wide block, 320 output columns in
# registers; 513 and 700: more than one block's 384 output columns, two
# blocks a head), with a ragged S, GQA, windows and softcaps.
# In 16 bits, 8, 24, 48, 72, 80, 96, 192 and 200 run on the wgmma kernel
# (columns past D zero-filled by TMA), 1, 36, 300, 320, 513 and 700 on the
# scalar one.
FA_ANY_D_CASES = [(1, 70, 2, 1, 1, 0, 0.0), (2, 33, 4, 2, 8, 8, 30.0),
                  (1, 100, 4, 2, 24, 0, 0.0), (2, 129, 4, 2, 48, 0, 0.0),
                  (1, 300, 4, 2, 80, 100, 50.0), (1, 257, 4, 4, 96, 0, 0.0),
                  (1, 96, 2, 1, 192, 0, 0.0), (1, 64, 4, 2, 200, 16, 0.0),
                  (1, 130, 4, 2, 320, 0, 50.0), (2, 70, 2, 1, 513, 40, 0.0),
                  (1, 200, 4, 2, 72, 64, 30.0), (2, 150, 4, 2, 36, 0, 50.0),
                  (1, 140, 4, 1, 300, 48, 0.0), (1, 70, 2, 1, 700, 0, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,softcap", FA_ANY_D_CASES)
def test_flash_attention_any_head_dim_on_card(card, rng, dtype, B, S, H,
                                              Hkv, D, window, softcap):
    """Every head dim runs a hand-written kernel, the one ``impl_for``
    names (wgmma for 16 bits at D % 8 == 0 up to 256, else scalar),
    launched and counted, within the bounds above against
    ``attention_ref``, at offset 0 and at a query offset."""
    q, k, v = _flash_case(rng, card, dtype, B, S, S, H, Hkv, D, softcap)
    impl = fa_ops.impl_for(dtype, D)
    assert impl == ("wgmma" if dtype != torch.float32 and D % 8 == 0
                    and D <= 256 else "scalar")
    by_impl = dict(fa_ops.LAUNCHES_BY_IMPL)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert fa_ops.LAUNCHES_BY_IMPL == by_impl
    assert out.dtype == dtype and out.shape == q.shape
    _flash_close(out, attention_ref(q, k, v, window=window,
                                    softcap=softcap), dtype)
    off = S // 3
    rows = q[:, off:].contiguous()
    part = fa_ops.flash_attention(rows, k, v, window=window,
                                  softcap=softcap, q_offset=off)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert fa_ops.LAUNCHES_BY_IMPL == by_impl
    _flash_close(part, attention_ref(rows, k, v, window=window,
                                     softcap=softcap, q_offset=off), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,Sq,Skv,off,H,Hkv,D,window,softcap",
                         FA_OFFSET_CASES)
def test_flash_attention_at_offset_matches_plain_on_card(
        card, rng, dtype, B, Sq, Skv, off, H, Hkv, D, window, softcap):
    """Both instances at a query offset against ``attention_ref`` at the
    same offset (the bounds of the offset-0 test above); the launch is
    counted in ``LAUNCHES_BY_OFFSET`` under its instance and offset."""
    q, k, v = _flash_case(rng, card, dtype, B, Sq, Skv, H, Hkv, D, softcap)
    impl = fa_ops.impl_for(dtype, D)
    before = dict(fa_ops.LAUNCHES_BY_OFFSET)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap,
                                 q_offset=off)
    torch.cuda.synchronize()
    before[(impl, off)] = before.get((impl, off), 0) + 1
    assert fa_ops.LAUNCHES_BY_OFFSET == before
    ref = attention_ref(q, k, v, window=window, softcap=softcap,
                        q_offset=off)
    assert out.dtype == dtype and out.shape == q.shape
    _flash_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 320),
                                     (torch.bfloat16, 36)])
@pytest.mark.parametrize("off,Sq,window", [(0, 300, 0), (128, 200, 0),
                                           (256, 77, 0), (100, 150, 0),
                                           (32, 96, 64), (200, 133, 64),
                                           (64, 150, 64)])
def test_flash_offset_rows_equal_full_launch_on_card(card, rng, dtype, D,
                                                     off, Sq, window):
    """An offset launch's rows against the same rows of one launch over
    every position: bit for bit where the offset is a multiple of the
    instance's q block (the same tiles in the same order; a tile a row's
    mask empties adds exactly 0), else within the bounds above."""
    Skv = 333
    q, k, v = _flash_case(rng, card, dtype, 2, Skv, Skv, 4, 2, D, 0.0)
    full = fa_ops.flash_attention(q, k, v, window=window)
    rows = q[:, off:off + Sq].contiguous()
    part = fa_ops.flash_attention(rows, k, v, window=window, q_offset=off)
    torch.cuda.synchronize()
    block = fa_ops.Q_BLOCK[fa_ops.impl_for(dtype, D)]
    want = full[:, off:off + Sq]
    if off % block == 0:
        assert torch.equal(part, want)
    else:
        _flash_close(part, want, dtype)


# Flash attention's gradient: B, Sq, Skv, q_offset, H, Hkv, D, window,
# softcap. Head dims 48, 64, 80, 96, 128, 256 (the wgmma instance in
# bfloat16 and float16, the FMA one in float32) and off it (36, 20, 320:
# the FMA instance at every dtype), G = 1, 2, 3, 4 and 10, windows,
# softcaps of 30 and 50, offsets on and off the instances' blocks (64 and
# 128 rows; a context-parallel shard's rows against every key), with
# ragged Sq and Skv
FA_BWD_CASES = [(2, 300, 300, 0, 4, 2, 64, 0, 0.0),
                (1, 257, 257, 0, 4, 4, 96, 0, 30.0),
                (1, 520, 520, 0, 16, 8, 128, 0, 0.0),
                (2, 200, 200, 0, 4, 2, 128, 64, 0.0),
                (1, 200, 600, 256, 4, 2, 128, 0, 0.0),
                (1, 130, 520, 390, 4, 2, 256, 100, 50.0),
                (1, 300, 300, 0, 10, 1, 256, 128, 0.0),
                (2, 150, 150, 0, 4, 2, 36, 0, 50.0),
                (1, 97, 140, 40, 4, 1, 20, 16, 0.0),
                (1, 70, 70, 0, 2, 1, 320, 0, 0.0),
                (1, 200, 333, 133, 4, 2, 48, 0, 50.0),
                (2, 190, 190, 0, 6, 3, 80, 64, 0.0),
                (1, 256, 640, 384, 4, 1, 64, 0, 50.0),
                (1, 77, 1100, 1000, 10, 1, 256, 2048, 0.0),
                (1, 333, 333, 0, 10, 1, 80, 0, 50.0)]


def _bwd_inputs(rng, card, dtype, B, Sq, Skv, off, H, Hkv, D, window,
                softcap):
    """q, k, v, dout and the forward's out and lse from the kernel."""
    q, k, v = _flash_case(rng, card, dtype, B, Sq, Skv, H, Hkv, D, softcap)
    dout = torch.from_numpy(rng.normal(0, 1, q.shape).astype(
        np.float32)).to(card, dtype)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=card)
    out = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap,
                                 q_offset=off, lse=lse)
    return q, k, v, dout, out, lse


def _bwd_launched(before, impl):
    """``before`` (a copy of ``LAUNCHES_BWD_BY_KERNEL``) after one backward
    call of instance ``impl``: each of its four kernels once, no other."""
    return {n: c + (n in fa_ops.BWD_KERNELS[impl])
            for n, c in before.items()}


def _within(got, want, bounds):
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.double() - w.double()).abs()
        assert bool((err <= b).all()), (name, float((err - b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,Sq,Skv,off,H,Hkv,D,window,softcap",
                         FA_BWD_CASES)
def test_flash_backward_matches_plain_on_card(card, rng, dtype, B, Sq, Skv,
                                              off, H, Hkv, D, window,
                                              softcap):
    """The gradient's instance ``bwd_impl_for`` names (four launches,
    counted per kernel: wgmma in bfloat16 and float16 at D % 8 == 0 up to
    256, tf32 otherwise up to D = 128, FMA above) against the chunked plain
    backward on the same card tensors, the same out and lse: within
    ``ref.backward_error_bound(same_stats=True)`` (both read the forward's
    statistics; they differ in the order of each sum), with the instance's
    ``split`` (``ops.BWD_SPLIT``: the wgmma instance's P and dS enter the
    products as 16-bit hi and lo halves, the tf32 instance's every operand
    as TF32 halves), and two calls bit for bit (no atomics)."""
    _bwd_case_on_card(card, rng, dtype, B, Sq, Skv, off, H, Hkv, D, window,
                      softcap)


def _want_bwd_impl(dtype, D):
    if dtype != torch.float32 and D % 8 == 0 and D <= 256:
        return "wgmma"
    return "tf32" if D <= 128 else "fma"


def _bwd_case_on_card(card, rng, dtype, B, Sq, Skv, off, H, Hkv, D, window,
                      softcap):
    """One backward case on the card against the plain backward (the test
    above); returns the instance."""
    q, k, v, dout, out, lse = _bwd_inputs(rng, card, dtype, B, Sq, Skv, off,
                                          H, Hkv, D, window, softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    impl = fa_ops.bwd_impl_for(dtype, D)
    assert impl == _want_bwd_impl(dtype, D)
    before = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    got = fa_ops.flash_attention_backward(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES_BWD_BY_KERNEL == _bwd_launched(before, impl)
    want = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, **kw)
    _within(got, want, fa_ref.backward_error_bound(
        q, k, v, out, dout, lse, **kw, same_stats=True,
        split=fa_ops.BWD_SPLIT[impl], ref=want))
    again = fa_ops.flash_attention_backward(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return impl


# tests/test_torch_flash_backward.py's TF32_CASES (the CPU emulation's
# shapes), B, Sq, Skv, off, H, Hkv, D, window, softcap, dtype; then qwen3's
# heads in float32 at 1 x 2048 (chip_smoke's path_f32)
TF32_CARD_CASES = [
    (1, 150, 150, 0, 4, 2, 20, 0, 0.0, torch.float32),
    (2, 70, 200, 130, 2, 1, 64, 50, 3.0, torch.float32),
    (1, 100, 300, 200, 4, 4, 100, 0, 0.0, torch.float32),
    (1, 260, 260, 0, 4, 1, 128, 100, 0.0, torch.float32),
    (1, 60, 130, 64, 4, 2, 8, 20, 5.0, torch.float32),
    (1, 200, 200, 0, 2, 1, 36, 64, 0.0, torch.bfloat16),
    (1, 97, 140, 40, 4, 1, 20, 16, 0.0, torch.float16),
    (1, 2048, 2048, 0, 16, 8, 128, 0, 0.0, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,off,H,Hkv,D,window,softcap,dtype",
                         TF32_CARD_CASES)
def test_flash_backward_tf32_on_card(card, rng, B, Sq, Skv, off, H, Hkv, D,
                                     window, softcap, dtype):
    """The tf32 instance (split pass, dK/dV and dQ on the tensor cores in
    three TF32 products a product) at the CPU emulation's shapes and at
    qwen3's float32 heads: within ``backward_error_bound(same_stats=True,
    split="tf32")`` of the plain backward, its four launches counted per
    kernel, two calls bit for bit."""
    assert _bwd_case_on_card(card, rng, dtype, B, Sq, Skv, off, H, Hkv, D,
                             window, softcap) == "tf32"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [136, 200])
def test_flash_backward_above_tf32_width_on_card(card, rng, D):
    """A float32 head dim above the tf32 instance's widest (128) stays on
    the FMA kernels and holds the float32 bound."""
    assert _bwd_case_on_card(card, rng, torch.float32, 1, 150, 180, 30, 4,
                             2, D, 0, 0.0) == "fma"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,window,softcap,off",
                         [(torch.bfloat16, 128, 0, 0.0, 0),
                          (torch.float16, 256, 100, 50.0, 0),
                          (torch.float32, 64, 0, 30.0, 70),
                          (torch.bfloat16, 36, 16, 0.0, 64)])
def test_flash_forward_lse_on_card(card, rng, dtype, D, window, softcap,
                                   off):
    """Both forward kernels' logsumexp against ``attention_lse_ref``'s on
    the card, within twice one side's error: |d lse| <= gamma(D + 2)
    max |scale q|.|k| (the scores) + gamma(Skv + 4) (the row sum) + 4u
    (max |s| + |lse|) (u = 2^-24, gamma(n) = n u / (1 - n u)); and the
    output's bytes with an lse asked for equal those without (serving)."""
    B, Sq, H, Hkv = 2, 300, 4, 2
    Skv = Sq + off
    q, k, v = _flash_case(rng, card, dtype, B, Sq, Skv, H, Hkv, D, softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=card)
    out = fa_ops.flash_attention(q, k, v, lse=lse, **kw)
    plain = fa_ops.flash_attention(q, k, v, **kw)
    assert torch.equal(out.view(torch.uint8), plain.view(torch.uint8))
    _, want = fa_ref.attention_lse_ref(q, k, v, **kw)
    u = 2.0 ** -24
    gamma = lambda n: n * u / (1 - n * u)
    G = H // Hkv
    qs = q.double().abs().reshape(B, Sq, Hkv, G, D) / D ** 0.5
    a = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.double().abs())
    s_max = a.amax(-1).reshape(B, H, Sq)
    tol = 2 * (gamma(D + 2) * s_max + gamma(Skv + 4)
               + 4 * u * (s_max + want.double().abs()))
    assert bool(((lse.double() - want.double()).abs() <= tol).all())


@pytest.mark.cuda
def test_flash_backward_at_32k_tokens_on_card(card):
    """qwen3's heads (16 q / 8 kv, D = 128) at its 32,768-token context,
    bfloat16: the gradient's wgmma instance runs with under 1 GiB of device
    memory above its inputs (dq, dk, dv, delta and the float32 shares:
    ~0.81 GB; autograd through ``attention_ref`` would need 68.7 GB for one
    score tensor) and matches the chunked plain backward within the bound
    of the test above."""
    S, H, Hkv, D = 32768, 16, 8, 128
    g = torch.Generator(device=card).manual_seed(5)
    q = (torch.randn((1, S, H, D), generator=g, device=card)
         * D ** -0.5).to(torch.bfloat16)
    k, v = (torch.randn((1, S, Hkv, D), generator=g, device=card)
            .to(torch.bfloat16) for _ in range(2))
    dout = torch.randn((1, S, H, D), generator=g, device=card).to(
        torch.bfloat16)
    lse = torch.empty((1, H, S), dtype=torch.float32, device=card)
    out = fa_ops.flash_attention(q, k, v, scale=1.0, lse=lse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    got = fa_ops.flash_attention_backward(q, k, v, out, dout, lse, scale=1.0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1 << 30
    assert fa_ops.LAUNCHES_BWD_BY_KERNEL == _bwd_launched(before, "wgmma")
    want = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, scale=1.0)
    _within(got, want, fa_ref.backward_error_bound(
        q, k, v, out, dout, lse, scale=1.0, same_stats=True, split=True,
        ref=want))


@pytest.mark.cuda
def test_ctx_prefill_on_logical_card_shards(card):
    """recurrentgemma ``:smoke`` on (1, 8) logical card shards, ``auto``
    picking ``ctx`` for its 4 heads over 8: the context-parallel prefill
    of 30 tokens (one flash launch a shard at offsets 0, 4, .., 28, the
    last shard 2 rows) against the unsharded prefill on the card, logits
    and every cache leaf within 1e-5 (float32, the CPU test's
    ``SERVE_ATOL``)."""
    from repro_torch.configs.base import ShapeConfig, ShardingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM

    cfg = get_config("recurrentgemma-2b:smoke")
    plain = LM(cfg, device=card, seed=1)
    params = plain.params()
    tok = torch.randint(0, cfg.vocab_size, (2, 30),
                        generator=torch.Generator().manual_seed(0)).to(card)
    mesh = _card_mesh(card, (1, 8))
    step, model = build_prefill_step(cfg, ShapeConfig("p", 30, 2, "prefill"),
                                     mesh, ShardingConfig())
    lay = step.layouts
    b = {"tokens": tok}
    at_offset = lambda: sum(n for (_, off), n in
                            fa_ops.LAUNCHES_BY_OFFSET.items() if off)
    n0 = at_offset()
    lg, cache = step(shd.place_tree(params, lay["params"], mesh),
                     shd.place_tree(b, lay["batch"](b), mesh))
    torch.cuda.synchronize()
    n_attn = cfg.layer_kinds.count("local") + cfg.layer_kinds.count("global")
    assert at_offset() - n0 == 7 * n_attn
    want_lg, want_c = plain.prefill(b)
    got_lg = shd.gather_tree(lg, [lay["logits"]], mesh)
    assert_allclose(got_lg.cpu().numpy(), want_lg.cpu().numpy(), rtol=0,
                    atol=1e-5)
    got_c = shd.gather_tree(cache, lay["cache"], mesh)
    for x, y in zip(tree.leaves(got_c), tree.leaves(want_c)):
        assert_allclose(x.float().cpu().numpy(), y.float().cpu().numpy(),
                        rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4096])
@pytest.mark.parametrize("T", [1, 1000])
@pytest.mark.parametrize("W", [16, 13])
def test_rglru_scan_bit_equal_on_card(card, rng, B, T, W):
    """W = 16 takes the kernel's float4 path, W = 13 its scalar one; T =
    1000 is not a multiple of the steps loaded ahead; B = 1 and 4096 rows."""
    C = lambda x: torch.from_numpy(x.astype(np.float32)).to(card)
    a = C(rng.uniform(0.5, 1.0, (B, T, W)))
    b, h0 = C(rng.normal(0, 1, (B, T, W))), C(rng.normal(0, 1, (B, W)))
    hs, h = rglru_ops.rglru_scan(a, b, h0)
    ref_hs, ref_h = rglru_scan_ref(a, b, h0)
    assert torch.equal(hs, ref_hs) and torch.equal(h, ref_h)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,M,T", [(256, 8, 32, 8), (3, 5, 17, 13),
                                     (1, 1, 1, 1)])
def test_harmonize_matches_plain_on_card(card, rng, E, S, M, T):
    ts = rng.uniform(-100, (T + 2) * 30, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.3
    vals[0, 0][~valid[0, 0]] = np.nan   # invalid NaN samples propagate
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    C = lambda x: torch.from_numpy(np.array(x)).to(card)
    before = hz_ops.LAUNCHES
    out, obs = hz_ops.harmonize(C(vals), C(ts), C(valid), C(ws), tick_s=30.0,
                                n_ticks=T)
    torch.cuda.synchronize()
    assert hz_ops.LAUNCHES == before + 1
    R = E * S
    t0 = C(np.repeat(ws, S))
    ref, ref_obs = harmonize_ref(C(vals).reshape(R, M), C(ts).reshape(R, M),
                                 C(valid).reshape(R, M), t0, 30.0, T)
    assert torch.equal(obs.reshape(R, T), ref_obs)
    torch.testing.assert_close(out.reshape(R, T), ref, rtol=1e-4, atol=1e-5,
                               equal_nan=True)


@pytest.mark.cuda
def test_bucketing_divides_exactly_on_card(card):
    """Samples on tick boundaries (k * 60 s) and one float32 ulp either
    side bucket as IEEE division puts them, in the kernel, its plain
    version and the pipeline's harmonize_segment alike. A Python-scalar
    division on CUDA (a reciprocal multiply) puts 180 / 60 at 3.0000002."""
    from repro_torch.core.frame import RawWindow
    from repro_torch.core.harmonize import harmonize_segment, tick_grid
    T, tick = 8, 60.0
    b = np.arange(0, T + 2, dtype=np.float32) * np.float32(tick)
    ts = np.concatenate([b, np.nextafter(b, np.float32(-1e9)),
                         np.nextafter(b, np.float32(1e9))])
    M = ts.size
    vals = np.arange(M, dtype=np.float32)
    idx = np.ceil(ts / np.float32(tick)).astype(np.int64) - 1
    want_obs = np.zeros(T, bool)
    want_obs[idx[(idx >= 0) & (idx < T)]] = True
    C = lambda x: torch.from_numpy(np.array(x)).to(card)
    v, t = C(vals[None, None]), C(ts[None, None])
    ok = torch.ones((1, 1, M), dtype=torch.bool, device=card)
    ws = torch.zeros((1,), device=card)
    out, obs = hz_ops.harmonize(v, t, ok, ws, tick_s=tick, n_ticks=T)
    ref, ref_obs = harmonize_ref(v[0], t[0], ok[0], ws, tick, T)
    seg, seg_obs = harmonize_segment(RawWindow(v, t, ok),
                                     tick_grid(ws, tick, T), tick, "mean")
    want = [vals[idx == j].mean() if want_obs[j] else 0.0 for j in range(T)]
    for o, m in ((out[0, 0], obs[0, 0]), (ref[0], ref_obs[0]),
                 (seg[0, 0], seg_obs[0, 0])):
        assert (m.cpu().numpy() == want_obs).all()
        assert_allclose(o.cpu().numpy(), want, rtol=1e-6)


def _sequential_harmonize(v, ts, ok, t0, tick_s, T):
    """(R, M) rows -> (means, observed) as a sequential float32 loop over
    the samples, one torch op at a time (nothing fused into an FMA):
    ``total = total + h * v``, ``count = count + h``."""
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


def _bits_equal(a, b):
    """Equal bit for bit, NaN positions included (any NaN's payload)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


def _nonfinite_rows(vals, ts, valid, ws, S, tick):
    """Rows 0-6 get NaN or +-inf values: in an invalid sample (0), a valid
    sample before the window (1), a sample that hits tick 0 (2: -inf, 3:
    NaN), +inf and -inf both hitting tick 0 (4), an invalid inf beside a
    hitting NaN (5), and a hitting +inf the only non-finite value of its
    row (6: tick 0 stays +inf, every other observed tick is NaN)."""
    M = vals.shape[-1]
    last = M - 1
    for row, m, value, ok, dt in (
            (0, 0, np.nan, False, 0.5), (1, 0, np.inf, True, -1.5),
            (2, 0, -np.inf, True, 0.5), (3, 0, np.nan, True, 0.5),
            (4, 0, np.inf, True, 0.5), (4, last, -np.inf, True, 0.5),
            (5, 0, np.inf, False, 0.5), (5, last, np.nan, True, 0.5),
            (6, 0, np.inf, True, 0.5)):
        e, s = divmod(row, S)
        vals[e, s, m], valid[e, s, m] = value, ok
        ts[e, s, m] = ws[e] + np.float32(dt * tick)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("M", [1, 17, 32, 128, 300])
@pytest.mark.parametrize("T", [1, 7, 8, 16, 17, 64, 100, 2000])
def test_harmonize_bit_equal_sequential_on_card(card, rng, T, M, offset):
    """The warp instance against a sequential float32 loop on the card, bit
    for bit with NaN positions, and ``observed`` against the plain version;
    (E, S) = (37, 3) rows, each input a contiguous view at storage offset
    ``offset`` (1: unaligned, so scalar loads), samples from a tick before
    the window to two after it, non-finite values as ``_nonfinite_rows``
    places them. T = 2000 takes more than 48 KB of shared memory a block,
    which the launch opts into."""
    E, S, tick = 37, 3, 30.0
    ts = rng.uniform(-tick, (T + 2) * tick, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.3
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    ts += ws[:, None, None]
    _nonfinite_rows(vals, ts, valid, ws, S, tick)

    def C(x):
        flat = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(card)
        buf = torch.empty(flat.numel() + offset, dtype=flat.dtype,
                          device=card)
        buf[offset:] = flat
        return buf[offset:].view(x.shape)
    v, t, ok, w = C(vals), C(ts), C(valid), C(ws)
    impl, vec = hz_ops.impl_for(M, aligned(v, t, ok), T)
    assert (impl, vec) == ("warp", offset == 0 and M % 4 == 0)
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    out, obs = hz_ops.harmonize(v, t, ok, w, tick_s=tick, n_ticks=T)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert hz_ops.LAUNCHES_BY_IMPL == by_impl
    R = E * S
    t0 = w.repeat_interleave(S)
    args = (v.reshape(R, M), t.reshape(R, M), ok.reshape(R, M), t0, tick, T)
    seq, seq_obs = _sequential_harmonize(*args)
    ref, ref_obs = harmonize_ref(*args)
    out, obs = out.reshape(R, T), obs.reshape(R, T)
    assert torch.equal(obs, ref_obs) and torch.equal(obs, seq_obs)
    assert _bits_equal(out, seq)
    # the non-finite rows did reach the output
    assert torch.isnan(out[:6]).any() and torch.isinf(out[6, 0])


@pytest.mark.cuda
def test_harmonize_tick_limit_on_card(card, rng):
    """``MAX_T`` ticks fit one warp's shared memory (a block of one warp)
    and run the warp instance, bit-equal to the sequential loop; one more
    runs the tiled instance (``LAUNCHES_BY_IMPL``), bit-equal to it too."""
    M, tick = 17, 0.5
    C = lambda x: torch.from_numpy(x).to(card)
    for T, impl in ((hz_ops.MAX_T, "warp"), (hz_ops.MAX_T + 1, "tiled")):
        ts = C(rng.uniform(-1, T * tick, (2, 3, M)).astype(np.float32))
        v = C(rng.normal(0, 5, (2, 3, M)).astype(np.float32))
        ok = C(rng.rand(2, 3, M) > 0.3)
        ws = torch.zeros((2,), device=card)
        by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
        out, obs = hz_ops.harmonize(v, ts, ok, ws, tick_s=tick, n_ticks=T)
        torch.cuda.synchronize()
        by_impl[impl] += 1
        assert hz_ops.LAUNCHES_BY_IMPL == by_impl
        seq, seq_obs = _sequential_harmonize(
            v.reshape(6, M), ts.reshape(6, M), ok.reshape(6, M),
            ws.repeat_interleave(3), tick, T)
        assert torch.equal(obs.reshape(6, T), seq_obs) and seq_obs.any()
        assert _bits_equal(out.reshape(6, T), seq)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("M", [17, 128, 2048, 5000])
@pytest.mark.parametrize("T", [hz_ops.MAX_T + 1, 20_160, 30_000])
def test_harmonize_tiled_bit_equal_sequential_on_card(card, rng, T, M,
                                                      offset):
    """The tiled instance (T above ``MAX_T``; 20,160 is a week of 30 s
    ticks) against the sequential float32 loop on the card, bit for bit
    with NaN positions, ``observed`` against it too; (E, S) = (5, 3) rows,
    aligned and at a storage offset of one element (scalar loads),
    samples from a tick before the window to one after it, non-finite
    values as ``_nonfinite_rows`` places them (hits, misses, invalid).
    M = 5000 takes three sorted chunks (``hz_ops.SORT_CHUNK``), and at
    T = 30,000 more than one staging tile of them."""
    E, S, tick = 5, 3, 30.0
    ts = rng.uniform(-tick, (T + 1) * tick, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.3
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    ts += ws[:, None, None]
    _nonfinite_rows(vals, ts, valid, ws, S, tick)

    def C(x):
        flat = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(card)
        buf = torch.empty(flat.numel() + offset, dtype=flat.dtype,
                          device=card)
        buf[offset:] = flat
        return buf[offset:].view(x.shape)
    v, t, ok, w = C(vals), C(ts), C(valid), C(ws)
    impl, vec = hz_ops.impl_for(M, aligned(v, t, ok), T)
    assert (impl, vec) == ("tiled", offset == 0 and M % 4 == 0)
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    out, obs = hz_ops.harmonize(v, t, ok, w, tick_s=tick, n_ticks=T)
    torch.cuda.synchronize()
    by_impl[impl] += 1
    assert hz_ops.LAUNCHES_BY_IMPL == by_impl
    R = E * S
    t0 = w.repeat_interleave(S)
    args = (v.reshape(R, M), t.reshape(R, M), ok.reshape(R, M))
    seq, seq_obs = _sequential_harmonize(*args, t0, tick, T)
    out, obs = out.reshape(R, T), obs.reshape(R, T)
    assert torch.equal(obs, seq_obs) and seq_obs.any()
    assert _bits_equal(out, seq)
    # the non-finite rows did reach the output
    assert torch.isnan(out[:6]).any() and torch.isinf(out[6, 0])
    # the last rows, all finite, against the plain version too (it holds
    # (rows, M, T) at once)
    ref, ref_obs = harmonize_ref(*(x[-2:] for x in args), t0[-2:], tick, T)
    assert torch.equal(obs[-2:], ref_obs)
    torch.testing.assert_close(out[-2:], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2048, 5000])
def test_harmonize_tiled_dense_ticks_bit_equal_on_card(card, rng, M):
    """Many samples a tick: the rows' samples fall on 40 ticks of a week
    (so every hit tick sums tens of values, where the order of the adds
    shows), in random M order, with repeated timestamps; the tiled
    instance's sorted runs against the sequential float32 loop, bit for
    bit."""
    E, S, T, tick = 4, 2, 20_160, 30.0
    hot = rng.choice(T, 40, replace=False)
    ts = ((hot[rng.randint(0, 40, (E, S, M))] + rng.choice(
        [0.25, 0.5, 0.75], (E, S, M))) * tick).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32) * \
        rng.choice([1e-3, 1.0, 1e3], (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.1
    C = lambda x: torch.from_numpy(x).to(card)
    v, t, ok, w = C(vals), C(ts), C(valid), torch.zeros((E,), device=card)
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    out, obs = hz_ops.harmonize(v, t, ok, w, tick_s=tick, n_ticks=T)
    torch.cuda.synchronize()
    by_impl["tiled"] += 1
    assert hz_ops.LAUNCHES_BY_IMPL == by_impl
    R = E * S
    seq, seq_obs = _sequential_harmonize(
        v.reshape(R, M), t.reshape(R, M), ok.reshape(R, M),
        w.repeat_interleave(S), tick, T)
    out, obs = out.reshape(R, T), obs.reshape(R, T)
    assert torch.equal(obs, seq_obs) and int(seq_obs.sum()) == R * 40
    assert _bits_equal(out, seq)


def _big_window(rng, K, E, S, M, T, tick, device):
    """K windows of (E, S, M) samples over T ticks: some ticks hold many
    samples, some none, a few samples fall outside the window."""
    return make_raw_window(
        rng.normal(5, 2, (K, E, S, M)).astype(np.float32),
        rng.uniform(-tick, (T + 1) * tick, (K, E, S, M)).astype(np.float32),
        rng.rand(K, E, S, M) > 0.3, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["mean", "sum", "last"])
def test_harmonize_segment_scatter_branch_is_deterministic_on_card(
        card, rng, agg):
    """M*T = 16384 > ``_DENSE_MT_MAX``: the scatter branch's sums run in a
    fixed order, so two calls agree bit for bit, and so do ``run_many`` and
    K single ticks (atomics would reorder the adds from run to run)."""
    E, S, M, T, K, tick = 8, 8, 128, 128, 3, 60.0
    assert M * T > hz._DENSE_MT_MAX
    raws = _big_window(rng, K, E, S, M, T, tick, card)
    raw = RawWindow(raws.values[0], raws.timestamps[0], raws.valid[0])
    grid = hz.tick_grid(torch.zeros((E,), device=card), tick, T)
    a, a_obs = hz.harmonize_segment(raw, grid, tick, agg)
    b, b_obs = hz.harmonize_segment(raw, grid, tick, agg)
    assert torch.equal(a_obs, b_obs) and a_obs.any() and not a_obs.all()
    assert _bits_equal(a, b)
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=T, tick_s=tick,
                         max_samples=M, agg=agg, feature_agg="mean",
                         use_kernel=True)
    starts = torch.zeros((K, E), device=card)
    with torch.no_grad():
        state, feats, frames = pl.run_many(cfg, pl.init_state(cfg, card),
                                           raws, starts)
        one = pl.init_state(cfg, card)
        for k in range(K):
            w = RawWindow(raws.values[k], raws.timestamps[k], raws.valid[k])
            one, f, fr = pl.tick(cfg, one, w, starts[k])
            assert _bits_equal(f.features, feats.features[k])
            assert _bits_equal(fr.values, frames.values[k])
            assert torch.equal(fr.observed, frames.observed[k])
    for x, y in zip(state.norm, one.norm):
        assert _bits_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("K,C", [(3, 8), (8, 8), (11, 4), (21, 4)])
def test_add_batch_bit_equal_sequential_adds_on_card(card, rng, K, C):
    """One write per leaf on the card == K guarded sequential ``add`` calls,
    row 0 masked, K > capacity included, and a second batch mid-ring."""
    E, F, A = 5, 4, 2
    C_ = lambda x: torch.from_numpy(np.array(x)).to(card)
    seq, got = rp.init(E, C, F, A, card), rp.init(E, C, F, A, card)
    for b in range(2):
        obs, nxt = (C_(rng.normal(0, 1, (K, E, F)).astype(np.float32))
                    for _ in range(2))
        act = C_(rng.normal(0, 1, (K, E, A)).astype(np.float32))
        rew = C_(rng.normal(0, 1, (K, E)).astype(np.float32))
        idx = C_(np.arange(b * K, (b + 1) * K, dtype=np.int32))
        ver = C_((np.arange(K) % 3).astype(np.int32))
        mask = rng.rand(K) > 0.3
        mask[0] = bool(b)
        for j in range(K):
            if mask[j]:
                rp.add(seq, obs[j], act[j], rew[j], nxt[j], idx[j], ver[j])
        rp.add_batch(got, obs, act, rew, nxt, idx, C_(mask), ver)
    for s_, g in zip(seq, got):
        assert g.device == s_.device and torch.equal(g, s_)


@pytest.mark.cuda
def test_run_many_decide_bit_equal_two_launch_path_on_card(card, rng):
    """The fused loop == ``run_many`` + ``on_windows`` on the card, bit for
    bit, over two batches with the rglru kernel and the pipeline kernels."""
    E, S, M, T, K = 16, 3, 32, 8, 6
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0,
                         max_samples=M, gap_strategy="locf",
                         feature_agg="mean", use_kernel=True)

    def predictor():
        return Predictor(PolicyConfig("rglru", {"hidden": 16,
                                                "use_kernel": True}),
                         energy_reward_spec(1, 0, 2),
                         ActionSpace(np.array([-1.0, -1.0]),
                                     np.array([1.0, 1.0])),
                         E, cfg.n_features, replay_capacity=8, device=card)

    ref, fus = predictor(), predictor()
    pipe = pl.PerceptaPipeline(cfg, mode="scan", device=card)
    fpipe = pl.PerceptaPipeline(cfg, mode="scan_fused_decide", device=card,
                                decide=fus.make_decide_fn())
    state, fstate, dstate = pipe.init_state(), fpipe.init_state(), \
        fus.decide_state()
    starts = torch.zeros((K, E), device=card)
    before = rglru_ops.LAUNCHES
    for b in range(2):
        raws = _big_window(rng, K, E, S, M, T, 60.0, card)
        with torch.no_grad():
            state, feats, _ = pipe.run_many(state, raws, starts)
            acts, rews, per = ref.on_windows(
                feats.features, [480.0 * (b * K + j + 1) for j in range(K)],
                raw=feats.raw)
            fstate, dstate, outs = fpipe.run_many_decide(fstate, dstate,
                                                         raws, starts)
        assert np.array_equal(outs.actions.cpu().numpy(), acts)
        assert np.array_equal(outs.rewards.cpu().numpy(), rews)
        assert np.array_equal(outs.per_term.cpu().numpy(), per)
        assert torch.equal(outs.features, feats.features)
    assert rglru_ops.LAUNCHES - before == 4 * K
    for x, y in zip(ref.replay, dstate.replay):
        assert torch.equal(x, y)
    assert torch.equal(ref._model_carry["h"], dstate.carry["h"])


def _tree_bits_equal(a, b):
    """Two trees of tensors equal leaf for leaf: device, dtype and bits."""
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _trainer_on_card(card, rng, n_rows, E=64, F=12, C=256, batch=128):
    """An mlp OnlineTrainer on the card over a ring of ``n_rows`` random
    transitions (``add_batch``, as the fused decide path banks them)."""
    pred = Predictor(PolicyConfig("mlp", {"hidden": 32}),
                     energy_reward_spec(1, 0, 2),
                     ActionSpace(np.array([-1.0, -1.0]),
                                 np.array([1.0, 1.0])),
                     E, F, replay_capacity=C, device=card)
    C_ = lambda x: torch.from_numpy(np.array(x)).to(card)
    if n_rows:
        rp.add_batch(pred.replay,
                     C_(rng.normal(0, 1, (n_rows, E, F)).astype(np.float32)),
                     C_(rng.uniform(-1, 1, (n_rows, E, 2)).astype(np.float32)),
                     C_(rng.normal(0, 3, (n_rows, E)).astype(np.float32)),
                     C_(rng.normal(0, 1, (n_rows, E, F)).astype(np.float32)),
                     C_(np.arange(n_rows, dtype=np.int32)))
    return tr.OnlineTrainer(pred, batch_size=batch, train_cfg=(
        tr.default_train_cfg(learning_rate=1e-2, weight_decay=0.1)))


@pytest.mark.cuda
def test_train_step_is_deterministic_on_card(card, rng):
    """Two steps from the same params, state, ring and indices give the
    same bits, three steps deep (critic, then policy, moving)."""
    t = _trainer_on_card(card, rng, 40)
    replay = t.predictor.replay
    params, tstate = t.predictor.policy_params, t.train_state
    for _ in range(3):
        es, ss = t.draw(replay)
        assert es.is_cuda and ss.is_cuda
        a = t.step_fn(params, tstate, replay, es, ss)
        b = t.step_fn(params, tstate, replay, es, ss)
        assert _tree_bits_equal(a, b)
        assert bool(a[4]) and all(x.is_cuda for x in tree.leaves(a))
        params, tstate = a[0], a[1]
    assert not _tree_bits_equal(params, t.predictor.policy_params)


@pytest.mark.cuda
def test_train_step_on_empty_ring_is_a_noop_on_card(card, rng):
    t = _trainer_on_card(card, rng, 0)
    ds = t.predictor.decide_state()
    policy0 = tree.map_(torch.clone, ds.policy)
    state0 = tree.map_(torch.clone, t.train_state)
    t.dispatch(ds)
    assert t.apply_pending(ds) is ds
    assert t.stats["skipped_empty"] == 1 and t.version == 0
    assert _tree_bits_equal(ds.policy, policy0)
    assert _tree_bits_equal(t.train_state, state0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp", "rwkv6"])
def test_registry_policy_decides_on_card_as_on_cpu(card, rng, name):
    E, F, A = 256, 24, 2
    cpu = build_policy(name, F, A, E, device="cpu")
    gpu = build_policy(name, F, A, E, device=card)
    assert all(p.is_cuda for p in gpu.params.values())
    assert all(torch.equal(p.cpu(), q) for p, q in zip(
        gpu.params.values(), cpu.params.values()))
    cc = cpu.init_carry(E) if cpu.init_carry else None
    gc = gpu.init_carry(E) if gpu.init_carry else None
    for _ in range(3):
        f = torch.from_numpy(rng.normal(0, 1, (E, F)).astype(np.float32))
        if cc is None:
            want, got = cpu(f), gpu(f.to(card))
        else:
            want, cc = cpu.apply_carry(cpu.params, f, cc)
            got, gc = gpu.apply_carry(gpu.params, f.to(card), gc)
            for k in cc:
                assert_allclose(gc[k].cpu().numpy(), cc[k].numpy(),
                                rtol=1e-5, atol=1e-5)
        assert got.is_cuda
        assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                        atol=1e-5)


# ------------------------------------------------------------ elastic pools
def _pool_device(dev):
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device(dev)


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
@pytest.mark.parametrize("policy", ["rglru", "mlp"])
@pytest.mark.parametrize("E,W", [(3, 4), (160, 256), (160, 512), (192, 256)])
def test_live_rows_do_not_depend_on_pool_width(dev, policy, E, W, rng):
    """The elastic contract at the loop's shape (S = 8, M = 32, T = 8, the
    kernels on): ``run_many_decide`` over E live rows inside a pool of W
    slots gives those rows the bits of a dense E-row run — outputs, state,
    carry and ring — over two batches. Every reduction of the tick and the
    decide step (multiply + sum, the reward terms) and every elementwise
    function must round a row the same at E and W rows."""
    dev = _pool_device(dev)
    S, M, T, K = 8, 32, 8, 4
    kw = dict(n_streams=S, n_ticks=T, tick_s=60.0, max_samples=M,
              gap_strategy="locf", feature_agg="mean", use_kernel=True)
    spec = PolicyConfig(policy, {"hidden": 16, "use_kernel": True}
                        if policy == "rglru" else {"hidden": 16})
    runs = []
    for n, elastic in ((E, False), (W, True)):
        cfg = PipelineConfig(n_envs=n, **kw)
        pred = Predictor(spec, energy_reward_spec(1, 0, 2),
                         ActionSpace(np.array([-1.0, -1.0]),
                                     np.array([1.0, 1.0])),
                         n, cfg.n_features, replay_capacity=6, device=dev)
        pipe = pl.PerceptaPipeline(cfg, mode="scan_fused_decide",
                                   device=dev, decide=pred.make_decide_fn(),
                                   elastic=elastic)
        dstate = pred.decide_state()
        if elastic:
            active = torch.arange(n, device=dev) < E
            dstate = dstate._replace(active=active,
                                     prev_ok=torch.zeros_like(active))
        runs.append([pipe, pipe.init_state(), dstate])
    g = np.random.RandomState(7)
    for b in range(2):
        raws = _big_window(g, K, W, S, M, T, 60.0, "cpu")
        raws = raws._replace(valid=raws.valid & (torch.arange(W) < E)
                             .reshape(1, W, 1, 1))
        starts = torch.zeros((K, W), device=dev)
        outs = []
        for r, n in zip(runs, (E, W)):
            pipe, state, dstate = r
            part = type(raws)(*(x[:, :n].to(dev) for x in raws))
            with torch.no_grad():
                r[1], r[2], out = pipe.run_many_decide(state, dstate, part,
                                                       starts[:, :n])
            outs.append(out)
        for name, x, y in zip(outs[0]._fields, *outs):
            assert torch.equal(x, y[:, :E]), (b, name)
    (_, sd, dd), (_, sw, dw) = runs
    for x, y in zip(tree.leaves(sd), tree.leaves(sw)):
        assert torch.equal(x, y if x.dim() == 0 else y[:E])
    for name in ("prev_obs", "prev_actions"):
        assert torch.equal(getattr(dd, name), getattr(dw, name)[:E]), name
    for x, y in zip(tree.leaves(dd.carry), tree.leaves(dw.carry)):
        assert torch.equal(x, y[:E])
    for name, x, y in zip(dd.replay._fields, dd.replay, dw.replay):
        assert torch.equal(x, y if x.dim() == 0 else y[:E]), name
    assert bool(dw.replay.valid[:E].any()) and \
        not bool(dw.replay.valid[E:].any())


@pytest.mark.cuda
def test_elastic_trees_on_card_equal_the_cpu(card, rng):
    """``reset_env_rows`` and ``grow_env_tree`` on card trees (a pipeline
    state and a ring) give the CPU's bits: they only copy and select."""
    from repro_torch.distribution import elastic as el
    E, S = 6, 8
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=8, max_samples=32)
    big = PipelineConfig(n_envs=2 * E, n_streams=S, n_ticks=8,
                         max_samples=32)
    noisy = lambda t: tree.map_(
        lambda x: torch.from_numpy(rng.normal(0, 1, x.shape).astype(
            np.float32)).to(x.dtype) if x.dim() else x, t)
    state = noisy(pl.init_state(cfg, "cpu"))
    ring = noisy(rp.init(E, 16, 8, 2, "cpu"))
    for t, tmpl in ((state, pl.init_state(cfg, "cpu")),
                    (ring, rp.init(E, 16, 8, 2, "cpu"))):
        on_card = tree.map_(lambda x: x.to(card), t)
        got = el.reset_env_rows(on_card, tree.map_(lambda x: x.to(card),
                                                   tmpl), [1, 4])
        want = el.reset_env_rows(t, tmpl, [1, 4])
        assert _tree_bits_equal(tree.map_(lambda x: x.cpu(), got), want)
    grown = el.grow_env_tree(tree.map_(lambda x: x.to(card), state),
                             pl.init_state(big, card), E)
    want = el.grow_env_tree(state, pl.init_state(big, "cpu"), E)
    assert _tree_bits_equal(tree.map_(lambda x: x.cpu(), grown), want)


@pytest.mark.cuda
@pytest.mark.parametrize("K,C", [(3, 8), (21, 4)])
def test_add_batch_env_mask_on_card_equals_cpu(card, rng, K, C):
    E, F, A = 5, 8, 2
    obs, nxt = (rng.normal(0, 1, (K, E, F)).astype(np.float32)
                for _ in range(2))
    act = rng.normal(0, 1, (K, E, A)).astype(np.float32)
    rew = rng.normal(0, 1, (K, E)).astype(np.float32)
    args = (obs, act, rew, nxt, np.arange(K, dtype=np.int32),
            rng.rand(K) > 0.2, np.zeros(K, np.int32))
    env_mask = rng.rand(K, E) > 0.4
    out = []
    for dev in ("cpu", card):
        buf = rp.init(E, C, F, A, device=dev)
        rp.add_batch(buf, *(torch.from_numpy(np.array(a)).to(dev)
                            for a in args),
                     env_mask=torch.from_numpy(env_mask).to(dev))
        out.append(buf)
    assert _tree_bits_equal(tree.map_(lambda x: x.cpu(), out[1]), out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bridge", [False, True])
def test_harmonize_interp_on_card_equals_cpu(card, rng, bridge):
    """At the loop's shape (E = 256, S = 8, T = 8, M = 32), NaN and +-inf
    samples and tied timestamps included: the card's values and
    ``observed`` equal the CPU's bit for bit (one selected sample a tick,
    or two tied ones, summed with zeros: exact in any order; the quotient,
    product and add are IEEE-rounded on both)."""
    E, S, M, T, tick = 256, 8, 32, 8, 60.0
    vals = rng.normal(5, 2, (E, S, M)).astype(np.float32)
    ts = rng.uniform(-tick, (T + 1) * tick, (E, S, M)).astype(np.float32)
    ts[:, :, 1] = ts[:, :, 0]                      # ties
    valid = rng.rand(E, S, M) < 0.3
    vals[rng.rand(E, S, M) < 0.01] = np.nan
    vals[rng.rand(E, S, M) < 0.01] = np.inf
    ticks = np.tile(np.arange(1, T + 1, dtype=np.float32) * tick, (E, 1))
    kw = {}
    if bridge:
        kw = dict(prev_value=rng.normal(5, 2, (E, S)).astype(np.float32),
                  prev_ts=rng.uniform(-600, 60, (E, S)).astype(np.float32))
    out = []
    for dev in ("cpu", card):
        raw = make_raw_window(vals, ts, valid, device=dev)
        dkw = {k: torch.from_numpy(v).to(dev) for k, v in kw.items()}
        v, obs = hz.harmonize_interp(raw, torch.from_numpy(ticks).to(dev),
                                     max_gap_s=300.0, **dkw)
        out.append((v.cpu(), obs.cpu()))
    assert torch.equal(out[0][1], out[1][1])
    assert _bits_equal(out[1][0], out[0][0])
    assert bool(torch.isnan(out[0][0]).any())


@pytest.mark.cuda
def test_detect_mad_on_card_equals_cpu(card, rng):
    """At the loop's shape: the spike mask exactly, the medians bit for
    bit (a sort, two picks, one add and one multiply)."""
    from repro_torch.core import anomaly as an
    E, S, T = 256, 8, 8
    v = rng.normal(10, 1, (E, S, T)).astype(np.float32)
    v[rng.rand(E, S, T) < 0.05] += 40.0
    v[rng.rand(E, S, T) < 0.01] = np.inf
    obs = rng.rand(E, S, T) < 0.8
    out = []
    for dev in ("cpu", card):
        x, o = torch.from_numpy(v).to(dev), torch.from_numpy(obs).to(dev)
        masked = torch.where(o, x, float("nan"))
        out.append((an.detect_mad(x, o).cpu(), an.nanmedian(masked).cpu()))
    assert torch.equal(out[0][0], out[1][0]) and bool(out[0][0].any())
    assert _bits_equal(out[1][1], out[0][1])


# ----------------------------------------------------------- env sharding
@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["rglru", "mlp"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_rows_do_not_depend_on_shard_width(card, policy, n, rng):
    """The sharding contract at the loop's shape (E = 256, S = 8, M = 32,
    T = 8, the kernels on): ``run_many_decide`` on n logical shards of the
    card (E/n rows each) gives every row the bits of the unsharded E-row
    run — outputs, state, carry and ring — over two batches, the twin of
    ``test_live_rows_do_not_depend_on_pool_width``. Each shard launches
    locf and rglru_scan once and window_agg twice a window."""
    from repro_torch.distribution import sharding as sh
    E, S, M, T, K = 256, 8, 32, 8, 4
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0,
                         max_samples=M, gap_strategy="locf",
                         feature_agg="mean", use_kernel=True)
    spec = PolicyConfig(policy, {"hidden": 16, "use_kernel": True}
                        if policy == "rglru" else {"hidden": 16})
    pred = Predictor(spec, energy_reward_spec(1, 0, 2),
                     ActionSpace(np.array([-1.0, -1.0]),
                                 np.array([1.0, 1.0])),
                     E, cfg.n_features, replay_capacity=6, device=card)
    decide = pred.make_decide_fn()
    ref = pl.PerceptaPipeline(cfg, mode="scan_fused_decide", device=card,
                              decide=decide)
    pipe = pl.PerceptaPipeline(cfg, mode="scan_fused_decide_sharded",
                               device=card, decide=decide,
                               mesh=sh.env_mesh(E, [card] * n))
    assert pipe.mesh.size == n
    dstate = pred.decide_state()
    shards = pipe.place_decide(tree.map_(lambda x: x.clone(), dstate))
    state, sstate = ref.init_state(), pipe.init_state()
    starts = torch.zeros((K, E), device=card)
    g = np.random.RandomState(7)
    for b in range(2):
        raws = _big_window(g, K, E, S, M, T, 60.0, card)
        with torch.no_grad():
            state, dstate, out = ref.run_many_decide(state, dstate, raws,
                                                     starts)
            before = (locf_ops.LAUNCHES, wagg_ops.LAUNCHES,
                      rglru_ops.LAUNCHES)
            sstate, shards, sout = pipe.run_many_decide(sstate, shards,
                                                        raws, starts)
        got = (locf_ops.LAUNCHES - before[0], wagg_ops.LAUNCHES - before[1],
               rglru_ops.LAUNCHES - before[2])
        assert got == (n * K, 2 * n * K, n * K if policy == "rglru" else 0)
        for name, x, y in zip(out._fields, out, sout):
            assert torch.equal(x, y), (b, name)
    assert _tree_bits_equal(state, pipe.gather_state(sstate))
    assert _tree_bits_equal(dstate, pipe.gather_decide(shards))
    assert sh.replicas_agree(shards, sh.decide_specs(shards[0], 0))


@pytest.mark.cuda
def test_kernels_and_shards_launch_on_a_second_card(card, rng):
    """Every wrapper launches on the card of its tensors, not the current
    one: with cuda:0 current, each kernel on cuda:1 tensors equals the same
    call on cuda:0; then ``run_many_decide`` over a mesh of both cards
    equals the unsharded engine on cuda:0 bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: a launch on a card other than "
                    "the current one can only be checked on a second card")
    from repro_torch.distribution import sharding as sh
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(d0)
    v = torch.from_numpy(rng.normal(0, 1, (4, 3, 8)).astype(np.float32))
    m = torch.from_numpy(rng.rand(4, 3, 8) > 0.4)
    c = torch.from_numpy(rng.normal(0, 1, (4, 3)).astype(np.float32))
    h = torch.from_numpy(rng.rand(4, 3) > 0.5)
    a = torch.from_numpy(rng.rand(4, 5, 16).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (1, 64, 2, 64)).astype(np.float32))
    calls = [
        lambda d: locf_ops.locf(v.to(d), m.to(d), c.to(d), h.to(d)),
        lambda d: wagg_ops.window_agg(v.to(d), m.to(d), c.to(d),
                                      c.abs().to(d)),
        lambda d: rglru_ops.rglru_scan(a.to(d), a.to(d), a[:, 0].to(d)),
        lambda d: hz_ops.harmonize(v.to(d), v.abs().to(d) * 60, m.to(d),
                                   torch.zeros(4, device=d), tick_s=60.0,
                                   n_ticks=4),
        lambda d: (fa_ops.flash_attention(q.to(d), q.to(d), q.to(d)),),
        lambda d: (fa_ops.flash_attention(q.to(d).bfloat16(),
                                          q.to(d).bfloat16(),
                                          q.to(d).bfloat16()),),
    ]
    for call in calls:
        want, got = call(d0), call(d1)
        torch.cuda.synchronize(d1)
        for x, y in zip(want, got):
            assert y.device == d1 and torch.equal(x, y.to(d0))
    E, S, M, T, K = 16, 3, 32, 8, 4
    cfg = PipelineConfig(n_envs=E, n_streams=S, n_ticks=T, tick_s=60.0,
                         max_samples=M, gap_strategy="locf",
                         feature_agg="mean", use_kernel=True)
    pred = Predictor(PolicyConfig("rglru", {"hidden": 16,
                                            "use_kernel": True}),
                     energy_reward_spec(1, 0, 2),
                     ActionSpace(np.array([-1.0, -1.0]),
                                 np.array([1.0, 1.0])),
                     E, cfg.n_features, replay_capacity=6, device=d0)
    decide = pred.make_decide_fn()
    ref = pl.PerceptaPipeline(cfg, mode="scan_fused_decide", device=d0,
                              decide=decide)
    pipe = pl.PerceptaPipeline(cfg, mode="scan_fused_decide_sharded",
                               device=d0, decide=decide,
                               mesh=sh.env_mesh(E, [d0, d1]))
    dstate = pred.decide_state()
    shards = pipe.place_decide(tree.map_(lambda x: x.clone(), dstate))
    assert shards[1].policy["w_in"].device == d1
    state, sstate = ref.init_state(), pipe.init_state()
    starts = torch.zeros((K, E), device=d0)
    for _ in range(2):
        raws = _big_window(rng, K, E, S, M, T, 60.0, d0)
        with torch.no_grad():
            state, dstate, out = ref.run_many_decide(state, dstate, raws,
                                                     starts)
            sstate, shards, sout = pipe.run_many_decide(sstate, shards,
                                                        raws, starts)
        assert _tree_bits_equal(out, sout)
    assert _tree_bits_equal(dstate, pipe.gather_decide(shards))


# ----------------------------------------------------- LM model families
@pytest.mark.cuda
def test_rglru_scan_long_t_bit_equal_on_card(card, rng):
    """The kernel at recurrentgemma-2b's prefill shape (4 x 2048 x 2560,
    the RG-LRU block's scan over the sequence) equals its plain version bit
    for bit."""
    B, T, W = 4, 2048, 2560
    g = torch.Generator(device=card).manual_seed(0)
    a = torch.rand((B, T, W), generator=g, device=card) * 0.5 + 0.5
    b = torch.randn((B, T, W), generator=g, device=card)
    h0 = torch.zeros((B, W), device=card)
    before = rglru_ops.LAUNCHES
    hs, h = rglru_ops.rglru_scan(a, b, h0)
    assert rglru_ops.LAUNCHES == before + 1
    ref_hs, ref_h = rglru_scan_ref(a, b, h0)
    assert torch.equal(hs, ref_hs) and torch.equal(h, ref_h)


def _family_lm(arch, card, **overrides):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config(arch + ":smoke"), **overrides)
    return cfg, LM(cfg, device=card, seed=0)


@pytest.mark.cuda
def test_moe_apply_is_deterministic_on_card(card, rng):
    """Two MoE calls on the same card tensors give the same bits (no
    atomics: the buffer is written by assignment and the k contributions
    of a token are summed in a fixed order), in bfloat16 at moonshot's 64
    experts, top 6, where the capacity drops assignments; the float32 call
    matches the CPU within 1e-4."""
    import dataclasses

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as pmoe
    from repro_torch.models import param as P
    for dt in ("bfloat16", "float32"):
        cfg, _ = _family_lm("moonshot-v1-16b-a3b", "cpu")
        cfg = dataclasses.replace(cfg, d_model=256, dtype=dt,
                                  param_dtype=dt,
                                  moe=MoEConfig(64, 6, 128))
        defs = pmoe.moe_defs(cfg)
        p = P.init(defs, torch.Generator(device=card).manual_seed(0), card)
        x = torch.randn((4, 512, 256), generator=torch.Generator(
            device=card).manual_seed(1), device=card).to(p["router"].dtype)
        counts = []
        out1, aux1 = pmoe.moe_apply(p, x, cfg, counts=counts)
        out2, aux2 = pmoe.moe_apply(p, x, cfg)
        assert torch.equal(out1, out2) and torch.equal(aux1, aux2)
        assert int(counts[0][0]) > 0
        if dt == "float32":
            cpu = pmoe.moe_apply({k: v.cpu() for k, v in p.items()},
                                 x.cpu(), cfg)[0]
            assert_allclose(out1.cpu().numpy(), cpu.numpy(), rtol=1e-4,
                            atol=1e-4)


@pytest.mark.cuda
def test_rwkv_chunked_matches_scan_on_card(card, rng):
    """The RWKV-6 prefill's chunked wkv (L = 16, S = 100: the pad path
    runs) against the sequential one on the card, float32, within 1e-4 on
    the logits and the carried state."""
    cfg, scan = _family_lm("rwkv6-1.6b", card)
    from repro_torch.models import LM
    chunked = LM(cfg, device=card, seed=0, rwkv_chunk=16)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 100))
                            .astype(np.int32)).to(card)
    want, wcache = scan.prefill({"tokens": toks})
    got, gcache = chunked.prefill({"tokens": toks})
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                    atol=1e-4)
    for w, g in zip(wcache["layers"], gcache["layers"]):
        assert_allclose(g["wkv"].cpu().numpy(), w["wkv"].cpu().numpy(),
                        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_recurrent_prefill_launches_its_kernels_on_card(card, rng):
    """recurrentgemma at 5 layers in bfloat16 with head dim 64: one
    rglru_scan launch per RG-LRU layer (4) and one flash-attention launch
    (wgmma) per attention layer (1) in a prefill; decode launches
    neither, and lands on the prefill's logits."""
    cfg, lm = _family_lm("recurrentgemma-2b", card, n_layers=5,
                         dtype="bfloat16", param_dtype="bfloat16",
                         head_dim=64)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40))
                            .astype(np.int32)).to(card)
    r0, f0 = rglru_ops.LAUNCHES, dict(fa_ops.LAUNCHES_BY_IMPL)
    full, _ = lm.prefill({"tokens": toks})
    assert rglru_ops.LAUNCHES - r0 == 4
    assert fa_ops.LAUNCHES_BY_IMPL["wgmma"] - f0["wgmma"] == 1
    _, cache = lm.prefill({"tokens": toks[:, :32]}, max_seq=41)
    r1 = rglru_ops.LAUNCHES
    for t in range(32, 40):
        logits, cache = lm.decode_step({"tokens": toks[:, t:t + 1]}, cache)
    assert rglru_ops.LAUNCHES == r1
    assert_allclose(logits.float().cpu().numpy(), full.float().cpu().numpy(),
                    rtol=2e-2, atol=2e-2)


# -------------------------------------------------------------- LM training
def _max_rel(got, want):
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,impl", [(torch.bfloat16, 128, "wgmma"),
                                          (torch.float16, 80, "wgmma"),
                                          (torch.bfloat16, 36, "scalar"),
                                          (torch.float32, 64, "scalar")])
def test_flash_attention_fn_forward_backward_on_card(card, dtype, D, impl):
    from repro_torch.models.layers import FlashAttentionFn
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, 256, h, D), generator=g, device=card)
               .to(dtype).requires_grad_() for h in (8, 4, 4))
    dout = torch.randn((2, 256, 8, D), generator=g, device=card).to(dtype)
    before = dict(fa_ops.LAUNCHES_BY_IMPL)
    out = FlashAttentionFn.apply(q, k, v, 0, 0.0)
    assert fa_ops.LAUNCHES_BY_IMPL[impl] == before[impl] + 1
    ref = attention_ref(q, k, v, scale=1.0)
    _flash_close(out.detach(), ref.detach(), dtype)
    bwd = dict(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    bwd_impl = fa_ops.bwd_impl_for(dtype, D)
    assert bwd_impl == ("wgmma" if impl == "wgmma" else "tf32")
    assert fa_ops.LAUNCHES_BY_IMPL[impl] == before[impl] + 1
    assert fa_ops.LAUNCHES_BWD_BY_KERNEL == _bwd_launched(bwd, bwd_impl)
    assert all(x.dtype == dtype for x in got)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    lse = torch.empty((2, 8, 256), dtype=torch.float32, device=card)
    fa_ops.flash_attention(qd, kd, vd, scale=1.0, lse=lse)
    _within(got, want, fa_ref.backward_error_bound(
        qd, kd, vd, out.detach(), dout, lse, scale=1.0,
        split=fa_ops.BWD_SPLIT[bwd_impl], ref=want))


@pytest.mark.cuda
def test_rglru_scan_fn_forward_backward_on_card(card):
    from repro_torch.models.rglru import RGLRUScanFn
    g = torch.Generator(device=card).manual_seed(0)
    B, T, W = 2, 300, 96
    a = torch.rand((B, T, W), generator=g, device=card).requires_grad_()
    b = torch.randn((B, T, W), generator=g, device=card).requires_grad_()
    h0 = torch.randn((B, W), generator=g, device=card).requires_grad_()
    w1 = torch.randn((B, T, W), generator=g, device=card)
    w2 = torch.randn((B, W), generator=g, device=card)
    n0 = rglru_ops.LAUNCHES
    hs, hl = RGLRUScanFn.apply(a, b, h0)
    got = torch.autograd.grad((hs * w1).sum() + (hl * w2).sum(), (a, b, h0))
    assert rglru_ops.LAUNCHES == n0 + 2          # forward, reversed scan
    hs2, hl2 = rglru_scan_ref(a, b, h0)
    assert torch.equal(hs, hs2) and torch.equal(hl, hl2)
    want = torch.autograd.grad((hs2 * w1).sum() + (hl2 * w2).sum(),
                               (a, b, h0))
    assert _max_rel(got, want) <= 1e-6


@pytest.mark.cuda
def test_lm_train_step_repeats_bit_for_bit_on_card(card):
    """qwen3 at 2 layers, head dim 64 (the scalar flash kernel in float32):
    two steps from one state and batch are bit-equal, and a ``full``-remat
    step launches flash attention twice a layer (forward, recompute)."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train import optimizer as opt

    cfg = dataclasses.replace(get_config("qwen3-0.6b:smoke"), head_dim=64)
    shape = ShapeConfig("t", 64, 4, "train")
    step, model = build_train_step(cfg, shape, TrainConfig(microbatches=2),
                                   card)
    params = tree.map_(lambda x: x.detach(), model.params())
    state = opt.init(params)
    batch = to_device(SyntheticLMStream(cfg.vocab_size, 4, 64)
                      .make_batch(0), card)
    n0 = fa_ops.LAUNCHES
    a = step(params, state, batch)
    assert fa_ops.LAUNCHES - n0 == 2 * cfg.n_layers * 2   # x 2 microbatches
    b = step(params, state, batch)
    assert _tree_bits_equal(a, b)
    assert bool(torch.isfinite(a[2]["loss"]))
    assert not _tree_bits_equal(a[0], params)


def _card_mesh(card, shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, devices=[card] * (shape[0] * shape[1]))


def _sharded_train_on(card, mesh, cfg, params, batch, tcfg):
    from repro_torch.configs.base import ShapeConfig, ShardingConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps
    step, _ = steps.build_train_step(
        cfg, ShapeConfig("t", batch["tokens"].shape[1],
                         batch["tokens"].shape[0], "train"), tcfg,
        mesh=mesh, perf=ShardingConfig())
    lay = step.layouts
    out = step(shd.place_tree(params, lay["params"], mesh),
               steps.init_opt_state(params, mesh, lay),
               shd.place_tree(batch, lay["batch"](batch), mesh))
    return out, lay


def _smoke_lm_on(card):
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMStream, to_device
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config("qwen3-0.6b:smoke"), head_dim=64)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    params = tree.map_(lambda x: x.detach(),
                       LM(cfg, device=card, seed=1).params())
    batch = to_device(SyntheticLMStream(cfg.vocab_size, 8, 32)
                      .make_batch(0), card)
    return cfg, tcfg, params, batch


@pytest.mark.cuda
def test_sharded_lm_steps_repeat_bit_for_bit_on_card(card):
    """qwen3 ``:smoke`` (head dim 64) on (2, 4) logical shards of the
    card: two ZeRO-3 steps from one state bit for bit, one flash launch a
    shard a layer, twice (forward and remat)."""
    cfg, tcfg, params, batch = _smoke_lm_on(card)
    mesh = _card_mesh(card, (2, 4))
    n0 = fa_ops.LAUNCHES
    a, _ = _sharded_train_on(card, mesh, cfg, params, batch, tcfg)
    assert fa_ops.LAUNCHES - n0 == mesh.size * cfg.n_layers * 2
    b, _ = _sharded_train_on(card, mesh, cfg, params, batch, tcfg)
    assert _tree_bits_equal(a, b)


@pytest.mark.cuda
def test_sharded_lm_step_on_logical_card_shards(card):
    """The same step against the unsharded step on the card: the loss
    within rtol 1e-5 and the new params within 1e-5
    (``tests/test_torch_model_sharded_steps.py``'s bounds at the
    ``:smoke`` widths)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import LM
    from repro_torch.train import optimizer as opt

    cfg, tcfg, params, batch = _smoke_lm_on(card)
    mesh = _card_mesh(card, (2, 4))
    a, lay = _sharded_train_on(card, mesh, cfg, params, batch, tcfg)
    step, _ = build_train_step(cfg, ShapeConfig("t", 32, 8, "train"), tcfg,
                               card, model=LM(cfg, device=card,
                                              params=params))
    want = step(params, opt.init(params), batch)
    assert_allclose(float(a[2]["loss"]), float(want[2]["loss"]), rtol=1e-5)
    got = shd.gather_tree(a[0], lay["params"], mesh)
    for x, y in zip(tree.leaves(got), tree.leaves(want[0])):
        assert x.device.type == "cuda"
        assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_moe_apply_sharded_on_card_matches_cpu(card):
    """Expert parallelism over (2, 4) logical shards of the card against
    the same call on the CPU's logical shards, rtol = atol = 1e-5 (the
    devices' products round differently); nothing dropped at a capacity
    that cannot drop, counted on the card."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import param as P

    cfg = get_config("phi3.5-moe-42b-a6.6b:smoke")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    g = torch.Generator().manual_seed(0)
    p = P.init(moe_mod.moe_defs(cfg), g, "cpu")
    x = torch.randn((4, 16, cfg.d_model), generator=g)
    want = moe_mod.moe_apply(p, x, cfg, shard=(_card_mesh(
        torch.device("cpu"), (2, 4)), ("pod", "data")))
    counts = []
    got = moe_mod.moe_apply(tree.map_(lambda t: t.to(card), p), x.to(card),
                            cfg, counts=counts,
                            shard=(_card_mesh(card, (2, 4)), ("pod",
                                                               "data")))
    assert got[0].device.type == "cuda"
    assert sum(int(c[0]) for c in counts) == 0
    assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=1e-5,
                    atol=1e-5)
    assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 16])
def test_owner_local_write_token_bit_for_bit_on_card(card, window):
    """``write_token(shard=)`` on (2, 4) logical shards of the card: only
    a slot's owner writes it, and the gathered cache equals the unsharded
    write bit for bit, global and ring, across the ring's wrap."""
    from repro_torch.models import cache as cache_lib

    g = torch.Generator(device=card).manual_seed(0)
    buf = torch.randn((4, 16, 2, 8), generator=g, device=card)
    new = torch.randn((4, 1, 2, 8), generator=g, device=card)
    mesh = _card_mesh(card, (2, 4))
    for lengths in ([0, 5, 9, 15], [3, 16, 21, 40]):
        L = torch.tensor(lengths, dtype=torch.int32, device=card)
        want = cache_lib.write_token(buf, new, L, window)
        got = cache_lib.write_token(buf, new, L, window,
                                    shard=(mesh, ("pod", "data")))
        assert got.device.type == "cuda" and torch.equal(got, want)
