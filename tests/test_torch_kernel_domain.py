"""The kernels' whole input domain against the JAX package's, on the CPU.

The reference's op entries take what the port's must take too:
flash_attention in float16 and at any head dim, harmonize at any tick
count, and locf, window_agg, rglru_scan and harmonize with values of any
dtype (cast to float32) and masks of any dtype (read as ``> 0`` after a
float32 cast, so a mask of -1 is False). On the CPU each port wrapper runs
its plain version; the CUDA instances themselves are held to their plain
versions on the card by ``test_torch_card.py``.

Tolerances:
  * flash_attention: float32 max abs err 2e-3 (``tests/test_kernels.py``'s
    bound for the Pallas kernel); bfloat16 one bfloat16 ulp of the
    reference, |got - want| <= 2^-7 |want| + 1e-5; float16 one float16
    ulp, |got - want| <= 2^-10 |want| + 1e-5. The reference is the Pallas
    kernel in interpret mode, which keeps p in float32 as the port does;
    both round the output once.
  * the float16 wgmma emulation (the card kernel's arithmetic with p
    split into float16 hi and lo halves) within the same one-ulp bound of
    ``attention_ref``, and a single float16 p far outside it;
  * harmonize: ``observed`` exact, means rtol 1e-4 / atol 1e-5 (the
    repo's bound); the tiled instance's order emulated in numpy, bit-equal
    to the sequential float32 loop, NaN positions included;
  * the op entries' casts: the same tolerances as their float32 tests in
    ``test_torch_kernels.py`` (exact selections and masks, 1e-5 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.harmonize.ops import harmonize as jax_harmonize
from repro.kernels.locf.ops import locf as jax_locf
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.kernels.window_agg.ops import window_agg as jax_window_agg
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (DENOM_FLOOR, MAX_FLOOR,
                                                     NEG_INF, attention_ref)
from repro_torch.kernels.harmonize import ops as hz_ops
from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.window_agg import ops as wagg_ops

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _flash_inputs(rng, dtype, B, S, H, Hkv, D, softcap):
    x = [rng.normal(0, 8 if softcap and h == H else 1, (B, S, h, D))
         .astype(np.float32) for h in (H, Hkv, Hkv)]
    # the same values on both sides: rounded to the dtype once
    return [torch.from_numpy(a).to(dtype) for a in x]


def _jax_flash(q, k, v, **kw):
    S = q.shape[1]
    blk = 64 if S % 64 == 0 else S
    conv = lambda t: jnp.asarray(t.float().numpy(), JNP[t.dtype])
    out = jax_flash_attention(conv(q), conv(k), conv(v), use_pallas=True,
                              q_blk=blk, kv_blk=blk, **kw)
    return np.asarray(out.astype(jnp.float32))


def _flash_close(got, want, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        assert np.abs(got - want).max() <= 2e-3
    else:
        bound = ULP[dtype] * np.abs(want) + 1e-5
        assert (np.abs(got - want) <= bound).all(), \
            (np.abs(got - want) / bound).max()


# (window, softcap): causal, a sliding window, a softcap of 50
VARIANTS = [(0, 0.0), (24, 0.0), (0, 50.0)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_flash_attention_float16_matches_jax(D, window, softcap, rng):
    """float16 at the wgmma kernel's head dims (GQA, ragged S = 70) against
    the Pallas kernel in interpret mode, within one float16 ulp."""
    q, k, v = _flash_inputs(rng, torch.float16, 2, 70, 4, 2, D, softcap)
    want = _jax_flash(q, k, v, window=window, softcap=softcap)
    got = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    assert got.dtype == torch.float16
    _flash_close(got, want, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 48, 80, 96, 320])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 50.0)])
def test_flash_attention_any_head_dim_matches_jax(dtype, D, window, softcap,
                                                  rng):
    """Head dims off the kernels' instance widths (8 below the narrowest,
    48, 80 and 96 inside wider ones, 320 above 256, the chunked case),
    causal and with a window and a softcap together."""
    q, k, v = _flash_inputs(rng, dtype, 1, 40, 4, 2, D, softcap)
    want = _jax_flash(q, k, v, window=window, softcap=softcap)
    got = fa_ops.flash_attention(q, k, v, window=window, softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("dtype,D", [(torch.float16, 128),
                                     (torch.bfloat16, 80),
                                     (torch.float32, 320)])
def test_flash_attention_at_offset_matches_jax(dtype, D, rng):
    """A context-parallel shard's rows (at offset 24 of 64 positions)
    against the same rows of the reference's whole causal pass, with a
    window and a softcap."""
    q, k, v = _flash_inputs(rng, dtype, 1, 64, 4, 2, D, 50.0)
    want = _jax_flash(q, k, v, window=32, softcap=50.0)[:, 24:48]
    got = fa_ops.flash_attention(q[:, 24:48].contiguous(), k, v, window=32,
                                 softcap=50.0, q_offset=24)
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [1, 8, 48, 64, 80, 96, 128, 192, 256, 320,
                               1000, 16, 200, 36])
def test_flash_attention_impl_for_every_dtype_and_head_dim(dtype, D):
    """The static kernel choice over the whole domain: bfloat16 and
    float16 at every head dim that is a multiple of 8 up to 256 on the
    wgmma kernel (D = 8 and 48 on its 64-column instance, 80 and 96 on
    128, 192 and 200 on 256), every other (dtype, D) on the scalar one:
    float32 at every D, and 16-bit at D = 1, 36 (not a multiple of 8, so
    its rows are not 16-byte aligned for TMA), 320 and 1000."""
    want = ("wgmma" if dtype != torch.float32 and D % 8 == 0 and D <= 256
            else "scalar")
    assert fa_ops.impl_for(dtype, D) == want
    assert fa_ops.Q_BLOCK[want] in (64, 128)


def test_flash_attention_refuses_other_dtypes():
    q = torch.zeros((1, 4, 2, 16), dtype=torch.float64)
    with pytest.raises(TypeError, match="float16"):
        fa_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])


def _wgmma_f16(q, k, v, *, window=0, softcap=0.0, split=True):
    """The float16 wgmma kernel's arithmetic all at once: float32 scores
    (a product of two float16 values is exact in float32), p in float32
    and l summed from it; for PV, p split into P_hi = f16(p) and P_lo =
    f16(p - P_hi) (``split=False``: p rounded once)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, S, Hkv, H // Hkv, D),
                     k.float()) / np.sqrt(D).astype(np.float32)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = (i >= j) & ((i - j < window) if window else True)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp(min=MAX_FLOOR))
    l = p.sum(-1, keepdim=True).clamp(min=DENOM_FLOOR)
    hi = p.to(torch.float16).float()
    parts = [hi, (p - hi).to(torch.float16).float()] if split else [hi]
    out = sum(torch.einsum("bhgqk,bkhd->bhgqd", x, v.float())
              for x in parts) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(torch.float16)


def _wgmma_f16_over_bound(rng, window, softcap, split):
    C = lambda sd, h: torch.from_numpy(rng.normal(
        0, sd, (1, 512, h, 128)).astype(np.float32)).to(torch.float16)
    q, k, v = C(8 if softcap else 1, 2), C(1, 1), C(1, 1)
    kw = dict(window=window, softcap=softcap)
    ref = attention_ref(q, k, v, **kw).float()
    got = _wgmma_f16(q, k, v, split=split, **kw).float()
    return ((got - ref).abs() / (2.0 ** -10 * ref.abs() + 1e-5)).max().item()


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (128, 0.0)])
def test_wgmma_float16_split_p_holds_one_ulp_bound(window, softcap, rng):
    """Why the float16 instance keeps the split: with it, the kernel's
    arithmetic stays within one float16 ulp of ``attention_ref`` (the
    card holds the kernel to two: its float32 tanh and exp differ from
    torch's in the last bits); with p rounded once to float16 it moves
    outputs near zero by more than ten times that bound."""
    assert _wgmma_f16_over_bound(rng, window, softcap, True) <= 1.0
    assert _wgmma_f16_over_bound(rng, window, softcap, False) > 10.0


def _fma(a, b, c):
    """float32 fma(a, b, c): the product is exact in float64 (24 + 24
    bits), the sum rounded once to float64 and then to float32 (a double
    rounding the card's fused op does not have, rare enough for an order
    emulation)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _scalar_flash(q, k, v, *, window=0, softcap=0.0, q_offset=0,
                  block=None):
    """The redesigned scalar kernel's order in numpy float32, (B, Sq, H,
    D) q and (B, Skv, Hkv, D) k, v: blocks of ``Q_BLOCK`` rows against
    tiles of 64 keys from the first tile a block's window reaches to the
    one holding its last row; each score one FMA chain over d in column
    order from 0 (q scaled first); softcap before the mask, the mask only
    on edge tiles, masked scores -1e30; each row's max and sum over the 16
    threads that share it (4 keys a thread: tx + 16 j in the narrow kernel,
    D <= 128, 4 tx + j in the wide one; summed in that order, then the xor
    butterfly 8, 4, 2, 1, so each thread keeps its own bits of l), the
    running max floored at -1e29, ``l = fma(l, alpha, sum)``; the
    accumulator times alpha, then one FMA chain over the tile's keys in
    order; out = acc / max(l of the column's thread, 1e-30)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    BQ = block or fa_ops.Q_BLOCK["scalar"]
    BK = 64
    scale = np.float32(1.0 / np.sqrt(D))
    qf = (q * scale).astype(np.float32)
    kv_head = np.arange(H) // G
    kf, vf = k[:, :, kv_head], v[:, :, kv_head]           # (B, Skv, H, D)
    out = np.zeros((B, Sq, H, D), np.float32)
    lane = np.arange(16)
    col_lane = (np.arange(D) % 64) // 4                     # a column's tx
    for q0 in range(0, Sq, BQ):
        rows = np.arange(q0, min(q0 + BQ, Sq))
        n = len(rows)
        p0 = q_offset + q0
        pos = q_offset + rows
        q_last = pos[-1]
        k_begin = max(0, p0 - window + 1) // BK * BK if window else 0
        m = np.full((B, H, n, 1), NEG_INF, np.float32)
        l = np.zeros((B, H, n, 16), np.float32)
        acc = np.zeros((B, H, n, D), np.float32)
        qb = qf[:, rows].transpose(0, 2, 1, 3)              # (B, H, n, D)
        for k0 in range(k_begin, q_last + 1, BK):
            keys = np.arange(k0, k0 + BK)
            live = keys < Skv
            kt = np.zeros((B, H, BK, D), np.float32)
            vt = np.zeros((B, H, BK, D), np.float32)
            kt[:, :, live] = kf[:, keys[live]].transpose(0, 2, 1, 3)
            vt[:, :, live] = vf[:, keys[live]].transpose(0, 2, 1, 3)
            sc = np.zeros((B, H, n, BK), np.float32)
            for d in range(D):
                sc = _fma(qb[..., d, None], kt[..., None, :, d], sc)
            if softcap:
                sc = (np.tanh(sc / np.float32(softcap)) *
                      np.float32(softcap)).astype(np.float32)
            edge = (k0 + BK - 1 > p0 or k0 + BK > Skv or
                    (window and p0 + BQ - 1 - k0 >= window))
            if edge:
                ok = (keys[None] <= pos[:, None]) & live[None]
                if window:
                    ok &= pos[:, None] - keys[None] < window
                sc = np.where(ok, sc, np.float32(NEG_INF))
            m_new = np.maximum(np.maximum(m, sc.max(-1, keepdims=True)),
                               np.float32(MAX_FLOOR))
            alpha = np.exp(m - m_new).astype(np.float32)
            m = m_new
            p = np.exp(sc - m_new).astype(np.float32)
            # (B, H, n, lane, key of the lane)
            part = (p.reshape(B, H, n, 4, 16).swapaxes(-1, -2) if D <= 128
                    else p.reshape(B, H, n, 16, 4))
            t = ((part[..., 0] + part[..., 1]) + part[..., 2]) + part[..., 3]
            for o in (8, 4, 2, 1):
                t = (t + t[..., lane ^ o]).astype(np.float32)
            l = _fma(l, alpha, t)
            acc = (acc * alpha).astype(np.float32)
            for j in range(BK):
                acc = _fma(p[..., j, None], vt[..., j, None, :], acc)
        denom = np.maximum(l[..., col_lane], np.float32(DENOM_FLOOR))
        out[:, rows] = (acc / denom).astype(np.float32).transpose(0, 2, 1, 3)
    return out


@pytest.mark.parametrize("D,window,softcap", [(24, 0, 0.0), (36, 40, 30.0),
                                              (136, 0, 50.0)])
def test_scalar_flash_order_holds_the_float32_bound(D, window, softcap, rng):
    """The redesigned scalar kernel's order (64-row blocks, 64-key tiles,
    each thread's 4 keys of a row: tx + 16 j in the narrow kernel at D <=
    128, 4 tx + j in the wide one; FMA chains over d and over keys,
    per-thread l),
    emulated in numpy float32 with GQA, a window and a softcap, against
    ``attention_ref`` at the card tests' float32 bound (2e-3, max abs),
    at offset 0 and at a query offset; and bit-equal to itself between an
    offset launch and the same rows of the full launch where the offset
    is a multiple of its 64-row q block (the same tiles in the same order:
    what ``tests/test_torch_card.py`` asks of the kernel)."""
    q, k, v = _flash_inputs(rng, torch.float32, 1, 150, 4, 2, D, softcap)
    kw = dict(window=window, softcap=softcap)
    qn, kn, vn = (x.numpy() for x in (q, k, v))
    full = _scalar_flash(qn, kn, vn, **kw)
    ref = attention_ref(q, k, v, **kw).numpy()
    assert np.abs(full - ref).max() <= 2e-3
    for off in (64, 40):
        part = _scalar_flash(qn[:, off:], kn, vn, q_offset=off, **kw)
        want = attention_ref(q[:, off:], k, v, q_offset=off, **kw).numpy()
        assert np.abs(part - want).max() <= 2e-3
        if off % fa_ops.Q_BLOCK["scalar"] == 0:
            assert np.array_equal(part.view(np.int32),
                                  full[:, off:].view(np.int32))


# ----------------------------------------------------------- harmonize
def _long_rows(rng, E, S, M, T, tick, nonfinite=False):
    """Samples spread over T ticks of ``tick`` seconds (some before the
    window and after it); with ``nonfinite``, NaN and +-inf in some."""
    ts = rng.uniform(-tick, (T + 1) * tick, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.3
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    ts += ws[:, None, None]
    if nonfinite:
        pick = rng.rand(E, S, M) < 0.05
        vals[pick] = rng.choice([np.nan, np.inf, -np.inf], pick.sum())
    return vals, ts, valid, ws


@pytest.mark.parametrize("T", [hz_ops.MAX_T + 1, 20_160])
def test_harmonize_long_matches_jax(T, rng):
    """Above the warp instance's ``MAX_T``, where the card runs the tiled
    instance (a week of 30 s ticks is 20,160): the op against the
    reference's op (its oracle, and its Pallas kernel in interpret mode)."""
    vals, ts, valid, ws = _long_rows(rng, 2, 3, 40, T, 30.0)
    got, got_obs = hz_ops.harmonize(*map(torch.from_numpy, (vals, ts, valid,
                                                            ws)),
                                    tick_s=30.0, n_ticks=T)
    assert got.shape == (2, 3, T) and got_obs.any()
    for use_pallas in (False, True):
        want, want_obs = map(np.asarray, jax_harmonize(
            vals, ts, valid, ws, tick_s=30.0, n_ticks=T,
            use_pallas=use_pallas))
        assert (got_obs.numpy() == want_obs).all()
        assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("M,aligned,T,want", [
    (32, True, 8, ("warp", True)), (33, False, hz_ops.MAX_T, ("warp", False)),
    (2048, True, hz_ops.MAX_T + 1, ("tiled", True)),
    (17, True, 20_160, ("tiled", False)),
    (2048, False, 20_160, ("tiled", False))])
def test_harmonize_impl_for_picks_tiled_above_max_t(M, aligned, T, want):
    """The static instance choice by T: ``warp`` up to ``MAX_T`` ticks,
    ``tiled`` above; vec as before."""
    assert hz_ops.impl_for(M, aligned, T) == want
    assert want[0] in hz_ops.LAUNCHES_BY_IMPL


def _keys(ts, valid, t0, tick, T):
    idx = np.ceil((ts - t0[:, None]) / np.float32(tick)).astype(np.int64) - 1
    return np.where(valid & (idx >= 0) & (idx < T), idx, -1)


def _means(total, count):
    obs = count > 0
    return (np.where(obs, total / np.maximum(count, np.float32(1)),
                     np.float32(0)).astype(np.float32), obs)


def _sequential(v, keys, T):
    """``total = total + h * v``, ``count = count + h`` over m, float32,
    one tick at a time (only the ticks a sample hits change but for
    non-finite values, which make every other tick NaN)."""
    R, M = v.shape
    total = np.zeros((R, T), np.float32)
    count = np.zeros_like(total)
    for m in range(M):
        h = np.zeros((R, T), np.float32)
        hit = keys[:, m] >= 0
        h[np.flatnonzero(hit), keys[hit, m]] = 1.0
        total = total + h * v[:, m, None]
        count = count + h
    return _means(total, count)


def _tiled(v, keys, T, tile=hz_ops.TILE, chunk=hz_ops.SORT_CHUNK):
    """The tiled instance's order: each row in chunks of ``chunk``
    samples, each chunk's samples stably sorted by tick (a miss sorts
    last), each tick's run of hits added one at a time, in M order, onto
    its running total in a staging tile of ``tile`` ticks (the whole row's
    ticks when it takes more than one chunk); then a tick's total is NaN
    where the row holds a non-finite value (anywhere) that does not hit
    it."""
    R, M = v.shape
    if M > chunk:
        tile = T
    total = np.zeros((R, T), np.float32)
    count = np.zeros_like(total)
    for r in range(R):
        runs = []    # per chunk: (tick, values in M order), tick ascending
        for c0 in range(0, M, chunk):
            k = np.where(keys[r, c0:c0 + chunk] >= 0, keys[r, c0:c0 + chunk],
                         T)
            order = np.argsort(k, kind="stable")
            ks, xs = k[order], v[r, c0:c0 + chunk][order]
            starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
            ends = np.r_[starts[1:], len(ks)]
            runs.append([(ks[a], xs[a:b]) for a, b in zip(starts, ends)
                         if ks[a] < T])
        for t_lo in range(0, T, tile):
            st = np.zeros(min(tile, T - t_lo), np.float32)
            sc = np.zeros_like(st)
            for chunk_runs in runs:
                for key, xs in chunk_runs:
                    if t_lo <= key < t_lo + tile:
                        acc = st[key - t_lo]
                        for x in xs:
                            acc = np.float32(acc + x)
                        st[key - t_lo] = acc
                        sc[key - t_lo] += len(xs)
            total[r, t_lo:t_lo + len(st)] = st
            count[r, t_lo:t_lo + len(st)] = sc
    for r in range(R):
        nf = keys[r, ~np.isfinite(v[r])]
        if nf.size:
            spared = nf[0] if nf.min() == nf.max() else -1
            total[r, np.arange(T) != spared] = np.nan
    return _means(total, count)


@pytest.mark.parametrize("nonfinite", [False, True])
def test_harmonize_tiled_order_is_the_sequential_loop(nonfinite, rng):
    """The tiled instance's order (each sample bucketed once, the chunk
    sorted by tick, each tick's run added in M order into
    ``hz_ops.TILE``-tick staging tiles) emulated in numpy float32 at T =
    20,160: bit-equal to the sequential loop (NaN positions included),
    ``observed`` equal, and within the repo's bound of the reference's
    oracle."""
    T = 20_160
    vals, ts, valid, ws = _long_rows(rng, 1, 3, 70, T, 30.0, nonfinite)
    R, M = 3, 70
    keys = _keys(ts.reshape(R, M), valid.reshape(R, M), np.repeat(ws, 3),
                 30.0, T)
    with np.errstate(invalid="ignore"):
        got, got_obs = _tiled(vals.reshape(R, M), keys, T)
        seq, seq_obs = _sequential(vals.reshape(R, M), keys, T)
    nan = np.isnan(got)
    assert (nan == np.isnan(seq)).all() and (got_obs == seq_obs).all()
    assert np.array_equal(np.where(nan, 0, got).view(np.int32),
                          np.where(nan, 0, seq).view(np.int32))
    assert nan.any() == nonfinite
    want, want_obs = map(np.asarray, jax_harmonize(
        vals, ts, valid, ws, tick_s=30.0, n_ticks=T, use_pallas=False))
    assert (got_obs == want_obs.reshape(R, T)).all()
    assert_allclose(got, want.reshape(R, T), rtol=1e-4, atol=1e-5,
                    equal_nan=True)


def test_harmonize_tiled_chunks_order_is_the_sequential_loop(rng):
    """More samples than one sorted chunk (``hz_ops.SORT_CHUNK``), crowded
    onto few ticks so that runs of three and more hits span chunks: the
    order of the chunks' runs, one staging tile over the whole week, is
    bit-equal to the sequential loop with NaN and +-inf in hits and
    misses."""
    T, R, M = 20_160, 2, hz_ops.SORT_CHUNK + 700
    ts = (rng.randint(0, 300, (1, R, M)) * 30.0 + 15.0).astype(np.float32)
    ts[0, :, ::7] = rng.uniform(-30, (T + 1) * 30, ts[0, :, ::7].shape)
    vals = rng.normal(0, 5, (1, R, M)).astype(np.float32)
    vals[0, 0, [5, 2500]] = [np.inf, -np.inf]
    vals[0, 1, 17] = np.nan
    valid = rng.rand(1, R, M) > 0.2
    ws = np.zeros((1,), np.float32)
    keys = _keys(ts.reshape(R, M), valid.reshape(R, M), np.repeat(ws, R),
                 30.0, T)
    assert np.bincount(keys[keys >= 0]).max() >= 3
    with np.errstate(invalid="ignore"):
        got, got_obs = _tiled(vals.reshape(R, M), keys, T)
        seq, seq_obs = _sequential(vals.reshape(R, M), keys, T)
    nan = np.isnan(got)
    assert (nan == np.isnan(seq)).all() and (got_obs == seq_obs).all()
    assert np.array_equal(np.where(nan, 0, got).view(np.int32),
                          np.where(nan, 0, seq).view(np.int32))
    assert nan.any()


# ------------------------------------------------- op entries' dtypes
def _as(x, kind):
    """numpy values in another dtype: float16, bfloat16 (as float32 values
    rounded to it), or int32."""
    if kind == "float16":
        return x.astype(np.float16)
    if kind == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return np.round(x * 4).astype(np.int32)


def _mask(m, kind, rng):
    """A bool mask as float32 (1 / -1 / 0.5 where True / False / True) or
    int32 (2 / -1 / 0): negative entries are False to the reference."""
    if kind == "float32":
        return np.where(m, rng.choice([1.0, 0.5], m.shape), -1.0) \
            .astype(np.float32)
    return np.where(m, 2, rng.choice([0, -1], m.shape)).astype(np.int32)


def _port(x, kind=None):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if kind == "bfloat16" else t


VALUE_KINDS = ["float16", "bfloat16", "int32"]
MASK_KINDS = ["float32", "int32"]


@pytest.mark.parametrize("vkind", VALUE_KINDS)
@pytest.mark.parametrize("mkind", MASK_KINDS)
def test_locf_entry_casts_as_the_reference(vkind, mkind, rng):
    E, S, T = 3, 3, 8
    v = _as(rng.normal(0, 1, (E, S, T)).astype(np.float32), vkind)
    o = _mask(rng.rand(E, S, T) > 0.5, mkind, rng)
    iv = _as(rng.normal(0, 1, (E, S)).astype(np.float32), vkind)
    ih = _mask(rng.rand(E, S) > 0.5, mkind, rng)
    want_v, want_h = map(np.asarray, jax_locf(
        jnp.asarray(v), jnp.asarray(o), jnp.asarray(iv), jnp.asarray(ih),
        use_pallas=False))
    got_v, got_h = locf_ops.locf(_port(v, vkind), _port(o), _port(iv, vkind),
                                 _port(ih))
    assert got_v.dtype == torch.float32 and got_h.dtype == torch.bool
    assert (got_h.numpy() == want_h).all()
    assert_allclose(got_v.numpy()[want_h], want_v[want_h], rtol=0, atol=0)


@pytest.mark.parametrize("vkind", VALUE_KINDS)
@pytest.mark.parametrize("mkind", MASK_KINDS)
def test_window_agg_entry_casts_as_the_reference(vkind, mkind, rng):
    E, S, T = 3, 3, 16
    v = _as(rng.normal(5, 2, (E, S, T)).astype(np.float32), vkind)
    m = _mask(rng.rand(E, S, T) > 0.3, mkind, rng)
    mu = _as(rng.normal(5, 1, (E, S)).astype(np.float32), vkind)
    var = _as((np.abs(rng.normal(1, 0.3, (E, S))) + 0.5).astype(np.float32),
              vkind)
    want_s, want_sp = map(np.asarray, jax_window_agg(
        jnp.asarray(v), jnp.asarray(m), jnp.asarray(mu), jnp.asarray(var),
        k_sigma=1.5, use_pallas=False))
    got_s, got_sp = wagg_ops.window_agg(_port(v, vkind), _port(m),
                                        _port(mu, vkind), _port(var, vkind),
                                        k_sigma=1.5)
    assert got_s.dtype == torch.float32 and got_sp.dtype == torch.bool
    assert (got_sp.numpy() == want_sp).all()
    assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vkind", VALUE_KINDS)
def test_rglru_scan_entry_casts_as_the_reference(vkind, rng):
    """The reference's kernel path casts a, b and h0 to float32 (its
    oracle path would keep the input dtype): the port follows the kernel
    path, float32 out."""
    a = _as(rng.uniform(0.5, 1.0, (3, 6, 16)).astype(np.float32), vkind)
    b = _as(rng.normal(0, 1, (3, 6, 16)).astype(np.float32), vkind)
    h0 = _as(rng.normal(0, 1, (3, 16)).astype(np.float32), vkind)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    want_hs, want_h = map(np.asarray, jax_rglru_scan(
        f32(a), f32(b), f32(h0), use_pallas=False))
    got_hs, got_h = rglru_ops.rglru_scan(_port(a, vkind), _port(b, vkind),
                                         _port(h0, vkind))
    assert got_hs.dtype == got_h.dtype == torch.float32
    assert_allclose(got_hs.numpy(), want_hs, rtol=1e-5, atol=1e-5)
    assert_allclose(got_h.numpy(), want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vkind", VALUE_KINDS)
@pytest.mark.parametrize("mkind", MASK_KINDS)
def test_harmonize_entry_casts_as_the_reference(vkind, mkind, rng):
    E, S, M, T = 2, 3, 20, 6
    ts = rng.uniform(-30, (T + 1) * 30, (E, S, M)).astype(np.float32)
    if vkind == "float16":
        ts = ts.astype(np.float16)
    v = _as(rng.normal(0, 5, (E, S, M)).astype(np.float32), vkind)
    ok = _mask(rng.rand(E, S, M) > 0.3, mkind, rng)
    ws = np.zeros((E,), np.float32)
    want, want_obs = map(np.asarray, jax_harmonize(
        jnp.asarray(v), jnp.asarray(ts), jnp.asarray(ok), jnp.asarray(ws),
        tick_s=30.0, n_ticks=T, use_pallas=False))
    got, got_obs = hz_ops.harmonize(_port(v, vkind), _port(ts), _port(ok),
                                    _port(ws), tick_s=30.0, n_ticks=T)
    assert got.dtype == torch.float32 and got_obs.dtype == torch.bool
    assert (got_obs.numpy() == want_obs).all()
    assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
