"""The port's five kernels against the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the JAX oracle (``ref.py``) and, for locf and window_agg, the
Pallas kernel in interpret mode. rglru_scan is held against its oracle
only: its Pallas path is red under the installed JAX. The CUDA kernels
themselves are held against their plain versions on the card by
``test_torch_card.py``. What the card's instances of locf and window_agg
do in another order than the plain versions is emulated here in numpy and
held against the JAX oracle: the warp instance's lane-then-butterfly
summation and its lane scan of LOCF.

Tolerances: bool outputs, counts, min/max/last and LOCF values where
``has`` is True are pure selection or exact integer counts and must match
exactly; float sums (window mean/var/sum, the recurrence) use rtol = atol =
1e-5, because XLA and torch add in different orders. harmonize:
``observed`` exact, means rtol 1e-4 / atol 1e-5 (``tests/test_kernels.py``'s
bound). flash_attention: 2e-3 in float32, the bound ``tests/test_kernels.py``
holds the Pallas kernel to; in bfloat16 one bfloat16 ulp of the reference
output, |got - want| <= 2^-7 |want| + 1e-5: both sides compute in float32
(p too) and round the output once, so their bfloat16 outputs differ by at
most one rounding step. Softcap cases scale q by 8, so that scores reach
tens and a cap of 50 changes the output far beyond the tolerance.
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
from repro_torch.kernels.harmonize import ops as hz_ops
from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.window_agg import ops as wagg_ops

TOL = dict(rtol=1e-5, atol=1e-5)
T_ = lambda x: torch.from_numpy(np.array(x))  # a writable private copy
# E*S = 9 and 15 rows: not multiples of the TPU's 8-row blocks
SHAPES = [(3, 3, 8), (5, 3, 16)]


def _locf_inputs(rng, E, S, T, empty_rows=True):
    v = rng.normal(0, 1, (E, S, T)).astype(np.float32)
    o = rng.rand(E, S, T) > 0.6
    if empty_rows:
        o[0, 0] = False   # an all-unobserved row with a carry-in
        o[-1, -1] = False  # ...and one without
    iv = rng.normal(0, 1, (E, S)).astype(np.float32)
    ih = rng.rand(E, S) > 0.5
    ih[0, 0], ih[-1, -1] = True, False
    return v, o, iv, ih


@pytest.mark.parametrize("E,S,T", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_locf_matches_jax(E, S, T, use_pallas, rng):
    v, o, iv, ih = _locf_inputs(rng, E, S, T)
    want_v, want_h = map(np.asarray,
                         jax_locf(v, o, iv, ih, use_pallas=use_pallas))
    got_v, got_h = locf_ops.locf(T_(v), T_(o), T_(iv), T_(ih))
    got_v, got_h = got_v.numpy(), got_h.numpy()
    assert (got_h == want_h).all()
    assert not got_h[-1, -1].any() and got_h[0, 0].all()
    assert np.array_equal(got_v[got_h], want_v[want_h])


def test_locf_carry_from_warmed_gapfill_state(rng):
    """Carry-in from a warmed gap-fill state: the port op equals the JAX
    gap-fill stage it replaces (same carry test ``last_ts > -1e29``)."""
    from repro.core import gapfill as jgf
    E, S, T = 3, 3, 8
    v, o, _, _ = _locf_inputs(rng, E, S, T)
    ticks = jnp.broadcast_to(jnp.arange(T, dtype=jnp.float32) * 60.0, (E, T))
    _, _, st = jgf.gap_fill(jnp.asarray(v), jnp.asarray(o), jgf.init_state(
        E, S), ticks, "locf")
    v2, o2, _, _ = _locf_inputs(rng, E, S, T)
    want_v, want_h = map(np.asarray, jgf.locf(jnp.asarray(v2),
                                              jnp.asarray(o2), st))
    got_v, got_h = locf_ops.locf(
        T_(v2), T_(o2), T_(np.asarray(st.last_value)),
        T_(np.asarray(st.last_ts) > -1e29))
    assert (got_h.numpy() == want_h).all()
    assert np.array_equal(got_v.numpy()[want_h], want_v[want_h])


def _wagg_inputs(rng, E, S, T):
    v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
    m = rng.rand(E, S, T) > 0.3
    m[0, 0] = False                      # an empty window
    mu = rng.normal(5, 1, (E, S)).astype(np.float32)
    var = (np.abs(rng.normal(1, 0.3, (E, S))) + 0.05).astype(np.float32)
    return v, m, mu, var


@pytest.mark.parametrize("E,S,T", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_window_agg_matches_jax(E, S, T, use_pallas, rng):
    v, m, mu, var = _wagg_inputs(rng, E, S, T)
    want_s, want_sp = map(np.asarray, jax_window_agg(
        v, m, mu, var, k_sigma=1.5, use_pallas=use_pallas))
    got_s, got_sp = wagg_ops.window_agg(T_(v), T_(m), T_(mu), T_(var),
                                        k_sigma=1.5)
    got_s, got_sp = got_s.numpy(), got_sp.numpy()
    assert (got_sp == want_sp).all() and want_sp.any()
    exact = [2, 3, 4, 5, 7]              # min, max, last, count, n_spikes
    assert np.array_equal(got_s[..., exact], want_s[..., exact])
    assert_allclose(got_s[..., [0, 1, 6]], want_s[..., [0, 1, 6]], **TOL)
    assert (got_s[0, 0] == 0).all()


@pytest.mark.parametrize("T,aligned,want", [
    (1, True, ("row", False)), (8, True, ("row", True)),
    (16, True, ("row", True)), (8, False, ("row", False)),
    (17, True, ("warp", False)), (64, True, ("warp", True)),
    (257, True, ("warp", False)), (64, False, ("warp", False))])
def test_row_kernels_impl_for(T, aligned, want):
    """The static instance choice of locf and window_agg: one thread per
    row up to 16 ticks, one warp per row above; vector pieces only where
    the pointers are aligned and T is a multiple of the piece (4 ticks for
    the row instance, 2 for the warp)."""
    assert locf_ops.impl_for(T, aligned) == want
    assert wagg_ops.impl_for(T, aligned) == want
    assert want[0] in locf_ops.LAUNCHES_BY_IMPL
    assert want[0] in wagg_ops.LAUNCHES_BY_IMPL


def _warp_lanes(x, T):
    """(R, T) -> (R, chunks, 32 lanes, 2): the warp instances' layout, lane
    l owning ticks 2l and 2l + 1 of each chunk of 64, zero past T."""
    R = x.shape[0]
    chunks = -(-T // 64)
    x = np.pad(x, ((0, 0), (0, chunks * 64 - T)))
    return x.reshape(R, chunks, 32, 2)


def _warp_window_sums(v, m):
    """mean, var and sum as ``window_agg.cu``'s warp instance adds them, in
    float32: each lane sums its masked ticks in tick order, chunk after
    chunk, then the lanes are summed by the __shfl_xor_sync butterfly
    (offsets 16, 8, 4, 2, 1; lane l adds lane l ^ off); the squared
    deviations from the mean likewise."""
    T = v.shape[1]
    v, m = _warp_lanes(v, T), _warp_lanes(m, T)
    lanes = np.arange(32)

    def total(x):
        acc = np.zeros((x.shape[0], 32), np.float32)
        for c in range(x.shape[1]):
            for j in range(2):
                acc = np.where(m[:, c, :, j], acc + x[:, c, :, j], acc)
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        assert (acc == acc[:, :1]).all()   # every lane holds the same bits
        return acc[:, 0]

    n = np.maximum(m.sum((1, 2, 3)).astype(np.float32), np.float32(1))
    s = total(v)
    mean = s / n
    d = v - mean[:, None, None, None]
    return mean, total(d * d) / n, s


@pytest.mark.parametrize("E,S,T", [(16, 8, 64), (4, 4, 1000)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_window_agg_warp_order_matches_jax(E, S, T, use_pallas, rng):
    """The warp instance's summation order, at the fleet's statistics
    (values ~ N(5, 2), 70% of ticks masked, T = 64) and at T = 1000 (16
    chunks), stays within rtol = atol = 1e-5 of the JAX oracle; its exact
    columns and spikes are order-free and equal."""
    v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
    m = rng.rand(E, S, T) < 0.7
    m[0, 0] = False
    mu = rng.normal(5, 1, (E, S)).astype(np.float32)
    var = (np.abs(rng.normal(1, 0.3, (E, S))) + 0.05).astype(np.float32)
    want_s, want_sp = map(np.asarray, jax_window_agg(
        v, m, mu, var, k_sigma=1.5, use_pallas=use_pallas))
    R = E * S
    want_s, want_sp = want_s.reshape(R, 8), want_sp.reshape(R, T)
    v, m = v.reshape(R, T), m.reshape(R, T)
    mean, var_, s = _warp_window_sums(v, m)
    assert_allclose(np.stack([mean, var_, s], -1), want_s[:, [0, 1, 6]],
                    **TOL)
    # count, min, max, last, n_spikes and spikes, as the lanes combine them
    spikes = m & (np.abs(v - mu.reshape(R, 1))
                  / np.sqrt(var.reshape(R, 1)) > 1.5)
    idx = np.where(m, np.arange(T), -1).max(-1)
    any_ = idx >= 0
    exact = np.stack([
        np.where(any_, np.where(m, v, np.inf).min(-1), 0),
        np.where(any_, np.where(m, v, -np.inf).max(-1), 0),
        np.where(any_, v[np.arange(R), idx], 0), m.sum(-1),
        spikes.sum(-1)], -1).astype(np.float32)
    assert np.array_equal(exact, want_s[:, [2, 3, 4, 5, 7]])
    assert np.array_equal(spikes, want_sp) and spikes.any()


def _warp_locf(v, o, iv, ih):
    """``locf.cu``'s warp instance in numpy: per chunk of 64 ticks, each lane
    combines its two ticks, five __shfl_up_sync steps scan the lanes under
    combine(l, r) = r.has ? r : l, and the carry (the carry-in, then the
    chunks before) enters ahead of lane 0."""
    R, T = v.shape
    v, o = _warp_lanes(v, T), _warp_lanes(o, T)
    lanes = np.arange(32)
    before = np.maximum(lanes - 1, 0)
    cv, ch = iv.copy(), ih.copy()
    out, has = np.empty_like(v), np.empty_like(o)
    for c in range(v.shape[1]):
        x, f = v[:, c], o[:, c]
        sv, sh = np.where(f[..., 1], x[..., 1], x[..., 0]), f.any(-1)
        for d in (1, 2, 4, 8, 16):
            take = (lanes >= d) & ~sh
            up = np.maximum(lanes - d, 0)
            sv, sh = np.where(take, sv[:, up], sv), np.where(take, sh[:, up],
                                                             sh)
        carry = (lanes == 0) | ~sh[:, before]
        pv = np.where(carry, cv[:, None], sv[:, before])
        ph = np.where(carry, ch[:, None], sh[:, before])
        out[:, c, :, 0] = np.where(f[..., 0], x[..., 0], pv)
        has[:, c, :, 0] = f[..., 0] | ph
        out[:, c, :, 1] = np.where(f[..., 1], x[..., 1], out[:, c, :, 0])
        has[:, c, :, 1] = f[..., 1] | has[:, c, :, 0]
        cv = np.where(sh[:, 31], sv[:, 31], cv)
        ch = ch | sh[:, 31]
    return out.reshape(R, -1)[:, :T], has.reshape(R, -1)[:, :T]


@pytest.mark.parametrize("E,S,T", [(16, 8, 64), (3, 5, 100), (2, 3, 1000)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_locf_warp_scan_matches_jax(E, S, T, use_pallas, rng):
    """The warp instance's lane scan carries the same observation forward
    as the JAX locf: has equal, values bit-equal where has is True (and the
    carry-in value where it is False, as the plain version returns it)."""
    v, o, iv, ih = _locf_inputs(rng, E, S, T)
    o &= rng.rand(E, S, T) < 0.1     # gaps that span lanes and chunks
    want_v, want_h = map(np.asarray,
                         jax_locf(v, o, iv, ih, use_pallas=use_pallas))
    R = E * S
    got_v, got_h = _warp_locf(v.reshape(R, T), o.reshape(R, T),
                              iv.reshape(R), ih.reshape(R))
    want_v, want_h = want_v.reshape(R, T), want_h.reshape(R, T)
    assert (got_h == want_h).all() and not got_h.all()
    assert np.array_equal(got_v[got_h], want_v[want_h])
    plain_v, _ = locf_ops.locf(T_(v), T_(o), T_(iv), T_(ih))
    assert np.array_equal(got_v, plain_v.numpy().reshape(R, T))


@pytest.mark.parametrize("B,T,W", [(4, 1, 16), (3, 12, 16), (2, 5, 7)])
def test_rglru_scan_matches_jax_oracle(B, T, W, rng):
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32)
    b = rng.normal(0, 1, (B, T, W)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, W)).astype(np.float32)
    want_hs, want_h = map(np.asarray,
                          jax_rglru_scan(a, b, h0, use_pallas=False))
    got_hs, got_h = rglru_ops.rglru_scan(T_(a), T_(b), T_(h0))
    assert_allclose(got_hs.numpy(), want_hs, **TOL)
    assert_allclose(got_h.numpy(), want_h, **TOL)
    assert torch.equal(got_hs[:, -1], got_h)


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 2, 1, 32),    # MQA
    (2, 256, 4, 2, 32),    # GQA
    (1, 128, 4, 4, 64),    # MHA
    (2, 100, 4, 2, 16),    # ragged S: one 100-row Pallas block
])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 50.0)])
def test_flash_attention_matches_jax(B, S, H, Hkv, D, window, softcap, rng):
    q = rng.normal(0, 8 if softcap else 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    blk = 64 if S % 64 == 0 else S
    want = jax_flash_attention(q, k, v, window=window, softcap=softcap,
                               use_pallas=True, q_blk=blk, kv_blk=blk)
    got = fa_ops.flash_attention(T_(q), T_(k), T_(v), window=window,
                                 softcap=softcap)
    assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
    if softcap:
        uncapped = fa_ops.flash_attention(T_(q), T_(k), T_(v), window=window)
        assert np.abs(uncapped.numpy() - np.asarray(want)).max() > 0.1


def _bf16_case(rng, S, softcap):
    B, H, Hkv, D = 1, 2, 1, 32
    x = [rng.normal(0, 8 if softcap and h == H else 1,
                    (B, S, h, D)).astype(np.float32) for h in (H, Hkv, Hkv)]
    blk = 64 if S % 64 == 0 else S
    want = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in x),
                               softcap=softcap, use_pallas=True, q_blk=blk,
                               kv_blk=blk)
    got = fa_ops.flash_attention(*(T_(a).to(torch.bfloat16) for a in x),
                                 softcap=softcap)
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    rtol=2.0 ** -7, atol=1e-5)


def test_flash_attention_bf16_matches_jax(rng):
    _bf16_case(rng, 128, 0.0)


def test_flash_attention_bf16_softcap_matches_jax(rng):
    """Ragged S = 100 with q scaled by 8 under a cap of 50."""
    _bf16_case(rng, 100, 50.0)


def _wgmma_rounding(q, k, v, *, window=0, softcap=0.0, split=True):
    """The bf16 wgmma kernel's arithmetic (``flash_attention_sm90.cu``), all
    at once rather than tile by tile: float32 scores from bf16 q and k (a
    product of two bf16 values is exact in float32), the scale applied to
    the scores, p in float32 and l summed from it; for PV, p split into
    P_hi = bf16(p) and P_lo = bf16(p - P_hi), each multiplied by v
    (``split=False``: p rounded once to bf16, the usual choice)."""
    from repro_torch.kernels.flash_attention.ref import (DENOM_FLOOR,
                                                         MAX_FLOOR, NEG_INF)
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
    hi = p.to(torch.bfloat16).float()
    parts = [hi, (p - hi).to(torch.bfloat16).float()] if split else [hi]
    out = sum(torch.einsum("bhgqk,bkhd->bhgqd", x, v.float())
              for x in parts) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(torch.bfloat16)


WGMMA_CASES = [("path", 0, 0.0), ("softcap", 0, 50.0), ("window", 128, 0.0)]


def _wgmma_rounding_over_bound(rng, window, softcap, split):
    """The largest |emulation - attention_ref| over the one-ulp bound
    2^-7 |ref| + 1e-5, at B = 1, 2 q heads over 1 kv head, S = 512,
    D = 128, bf16 inputs."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    C = lambda sd, h: torch.from_numpy(rng.normal(
        0, sd, (1, 512, h, 128)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = C(8 if softcap else 1, 2), C(1, 1), C(1, 1)
    kw = dict(window=window, softcap=softcap)
    ref = attention_ref(q, k, v, **kw).float()
    got = _wgmma_rounding(q, k, v, split=split, **kw).float()
    return ((got - ref).abs() / (2.0 ** -7 * ref.abs() + 1e-5)).max().item()


@pytest.mark.parametrize("label,window,softcap", WGMMA_CASES)
def test_wgmma_split_p_holds_one_ulp_bound(label, window, softcap, rng):
    """p split into bf16 hi and lo for PV stays within one bf16 ulp of the
    float32-p reference (the bound chip_smoke.py holds the kernel to)."""
    assert _wgmma_rounding_over_bound(rng, window, softcap, True) <= 1.0


@pytest.mark.parametrize("label,window,softcap", WGMMA_CASES)
def test_wgmma_single_bf16_p_breaks_one_ulp_bound(label, window, softcap,
                                                  rng):
    """Why the kernel splits p: rounded once to bf16, p moves outputs near
    zero by many times the bound."""
    assert _wgmma_rounding_over_bound(rng, window, softcap, False) > 10.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fa_ops.HEAD_DIMS)
def test_flash_attention_impl_for(dtype, D):
    """The static kernel choice: bf16 at head dims 64, 128 and 256 on the
    wgmma kernel; float32, and bf16 at 16 and 32, on the scalar one."""
    want = "wgmma" if dtype == torch.bfloat16 and D >= 64 else "scalar"
    assert fa_ops.impl_for(dtype, D) == want
    assert want in fa_ops.LAUNCHES_BY_IMPL


def _harmonize_case(seed):
    """The draw of ``tests/test_kernels.py::test_harmonize_property``."""
    rng = np.random.RandomState(seed)
    E, S = rng.randint(1, 4), rng.randint(1, 5)
    M, T = rng.randint(1, 48), rng.randint(1, 24)
    ts = rng.uniform(-100, (T + 2) * 30, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.5
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    return vals, ts, valid, ws, T


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42, 1234, 65535])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_harmonize_matches_jax(seed, use_pallas):
    vals, ts, valid, ws, T = _harmonize_case(seed)
    want, want_obs = map(np.asarray, jax_harmonize(
        vals, ts, valid, ws, tick_s=30.0, n_ticks=T, use_pallas=use_pallas))
    got, got_obs = hz_ops.harmonize(T_(vals), T_(ts), T_(valid), T_(ws),
                                    tick_s=30.0, n_ticks=T)
    assert got_obs.dtype == torch.bool
    assert (got_obs.numpy() == want_obs).all()
    assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _harmonize_draw(rng, E, S, M, T, nonfinite):
    """Samples as ``_harmonize_case`` draws them; with ``nonfinite``, NaN,
    +inf or -inf in about one sample in eight (invalid ones, valid ones
    outside the window, ones that hit a tick), and row (0, 0) holding one
    +inf that hits tick 0 and nothing else non-finite (tick 0 stays +inf,
    its other observed ticks turn NaN)."""
    ts = rng.uniform(-100, (T + 2) * 30, (E, S, M)).astype(np.float32)
    vals = rng.normal(0, 5, (E, S, M)).astype(np.float32)
    valid = rng.rand(E, S, M) > 0.5
    ws = rng.uniform(-50, 50, (E,)).astype(np.float32)
    if nonfinite:
        pick = rng.rand(E, S, M) < 0.125
        vals[pick] = rng.choice([np.nan, np.inf, -np.inf], pick.sum())
        vals[0, 0] = rng.normal(0, 5, M)
        vals[0, 0, 0], valid[0, 0, 0] = np.inf, True
        ts[0, 0, 0] = ws[0] + np.float32(15.0)
    return vals, ts, valid, ws


def _harmonize_cases(seed, nonfinite):
    """A ``_harmonize_case``-sized draw and one of 130 samples a row (five
    32-sample chunks, the last partial) into 20 ticks."""
    rng = np.random.RandomState(seed)
    E, S = rng.randint(1, 4), rng.randint(1, 5)
    M, T = rng.randint(1, 48), rng.randint(1, 24)
    yield (*_harmonize_draw(rng, E, S, M, T, nonfinite), T)
    yield (*_harmonize_draw(rng, 2, 3, 130, 20, nonfinite), 20)


def _jax_harmonize(vals, ts, valid, ws, T, use_pallas):
    return map(np.asarray, jax_harmonize(vals, ts, valid, ws, tick_s=30.0,
                                         n_ticks=T, use_pallas=use_pallas))


@pytest.mark.parametrize("M,aligned,want", [
    (1, True, ("warp", False)), (3, True, ("warp", False)),
    (4, True, ("warp", True)), (32, True, ("warp", True)),
    (33, True, ("warp", False)), (128, True, ("warp", True)),
    (300, True, ("warp", True)), (32, False, ("warp", False)),
    (128, False, ("warp", False))])
def test_harmonize_impl_for(M, aligned, want):
    """harmonize's one instance serves every shape; it stages float4 loads
    only where the pointers are 16-byte aligned and M % 4 == 0."""
    assert hz_ops.impl_for(M, aligned) == want
    assert want[0] in hz_ops.LAUNCHES_BY_IMPL


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42, 1234, 65535])
def test_harmonize_nonfinite_matches_jax_oracle(seed):
    """Non-finite values in invalid, out-of-range and hitting samples: the
    port against the oracle (``use_pallas=False``), NaN and inf where it
    has them, ``observed`` exact, means at 1e-4 / 1e-5."""
    nans = 0
    for vals, ts, valid, ws, T in _harmonize_cases(seed, nonfinite=True):
        want, want_obs = _jax_harmonize(vals, ts, valid, ws, T, False)
        got, got_obs = hz_ops.harmonize(T_(vals), T_(ts), T_(valid),
                                        T_(ws), tick_s=30.0, n_ticks=T)
        assert (got_obs.numpy() == want_obs).all()
        assert np.isinf(want[0, 0, 0])
        nans += np.isnan(want).sum()
        assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5,
                        equal_nan=True)
    assert nans > 0


def test_harmonize_nonfinite_miss_follows_the_oracle():
    """One row, values [1, NaN, 2, inf] at [10, 10, 40, 400] s, valid [1,
    0, 1, 1], 30 s ticks, T = 3: samples 1 (invalid) and 3 (after the
    window) miss both observed ticks. The hit weight is multiplied into
    the value, so 0 * NaN and 0 * inf make both totals NaN: the oracle
    (``use_pallas=False``) and the port give [NaN, NaN, 0]. The Pallas
    kernel in interpret mode gives [1, 2, 0]: XLA rewrites its 0/1 product
    into a select, which drops the non-finite misses. So the Pallas path
    is not the comparison for non-finite values; the oracle is."""
    vals = np.array([[[1.0, np.nan, 2.0, np.inf]]], np.float32)
    ts = np.array([[[10.0, 10.0, 40.0, 400.0]]], np.float32)
    valid = np.array([[[True, False, True, True]]])
    ws = np.zeros((1,), np.float32)
    want = np.array([np.nan, np.nan, 0.0], np.float32)
    oracle, oracle_obs = _jax_harmonize(vals, ts, valid, ws, 3, False)
    pallas, pallas_obs = _jax_harmonize(vals, ts, valid, ws, 3, True)
    got, got_obs = hz_ops.harmonize(T_(vals), T_(ts), T_(valid), T_(ws),
                                    tick_s=30.0, n_ticks=3)
    np.testing.assert_array_equal(oracle[0, 0], want)
    np.testing.assert_array_equal(got.numpy()[0, 0], want)
    np.testing.assert_array_equal(pallas[0, 0], [1.0, 2.0, 0.0])
    for obs in (oracle_obs, pallas_obs, got_obs.numpy()):
        assert obs[0, 0].tolist() == [True, True, False]


def _bucket_keys(ts, valid, t0, T):
    """Each sample's tick as the kernel computes it (float32 subtract, IEEE
    divide, ceil, minus 1), or -1 where it hits none."""
    idx = np.ceil((ts - t0[:, None]) / np.float32(30.0)).astype(np.int64) - 1
    return np.where(valid & (idx >= 0) & (idx < T), idx, -1)


def _tick_means(total, count):
    observed = count > 0
    return (np.where(observed, total / np.maximum(count, np.float32(1)),
                     np.float32(0)).astype(np.float32), observed)


def _sequential_harmonize(v, keys, T):
    """``total = total + h * v``, ``count = count + h`` over m in float32."""
    ticks = np.arange(T)
    total = np.zeros((v.shape[0], T), np.float32)
    count = np.zeros_like(total)
    for m in range(v.shape[1]):
        h = (keys[:, m, None] == ticks).astype(np.float32)
        total = total + h * v[:, m, None]
        count = count + h
    return _tick_means(total, count)


def _warp_harmonize(v, keys, T):
    """The warp instance's order: per 32-sample chunk, each bucket's lanes
    added in lane order onto the tick's running total; then a tick's total
    is NaN where the row has a non-finite value that does not hit it (the
    row's non-finite values' keys are not all that tick)."""
    R, M = v.shape
    total = np.zeros((R, T), np.float32)
    count = np.zeros_like(total)
    for r in range(R):
        for c0 in range(0, M, 32):
            k, x = keys[r, c0:c0 + 32], v[r, c0:c0 + 32]
            for key in np.unique(k[k >= 0]):
                s = total[r, key]
                for j in np.flatnonzero(k == key):
                    s = np.float32(s + x[j])
                total[r, key] = s
                count[r, key] += np.float32((k == key).sum())
        nf_keys = keys[r, ~np.isfinite(v[r])]
        if nf_keys.size:
            spared = nf_keys[0] if nf_keys.min() == nf_keys.max() else -1
            total[r, np.arange(T) != spared] = np.nan
    return _tick_means(total, count)


def _bits_equal(a, b):
    nan = np.isnan(a)
    return (nan == np.isnan(b)).all() and np.array_equal(
        np.where(nan, 0, a).view(np.int32), np.where(nan, 0, b).view(np.int32))


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42, 1234, 65535])
def test_harmonize_warp_order_matches_jax(seed, nonfinite):
    """The card's warp instance emulated in numpy float32: bit-equal to the
    sequential loop over the samples (it keeps M order), and held against
    the Pallas kernel in interpret mode on finite inputs and against the
    oracle on non-finite ones (the Pallas path drops non-finite misses) at
    1e-4 / 1e-5, ``observed`` exact."""
    with np.errstate(invalid="ignore"):
        for vals, ts, valid, ws, T in _harmonize_cases(seed, nonfinite):
            E, S, M = vals.shape
            R = E * S
            keys = _bucket_keys(ts.reshape(R, M), valid.reshape(R, M),
                                np.repeat(ws, S), T)
            got, got_obs = _warp_harmonize(vals.reshape(R, M), keys, T)
            seq, seq_obs = _sequential_harmonize(vals.reshape(R, M), keys,
                                                 T)
            assert _bits_equal(got, seq) and (got_obs == seq_obs).all()
            want, want_obs = _jax_harmonize(vals, ts, valid, ws, T,
                                            use_pallas=not nonfinite)
            assert (got_obs == want_obs.reshape(R, T)).all()
            assert_allclose(got, want.reshape(R, T), rtol=1e-4, atol=1e-5,
                            equal_nan=True)


def test_cpu_path_counts_no_launch(rng):
    before = (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES,
              hz_ops.LAUNCHES, fa_ops.LAUNCHES)
    by_impl = dict(hz_ops.LAUNCHES_BY_IMPL)
    v, o, iv, ih = _locf_inputs(rng, 2, 2, 4)
    locf_ops.locf(T_(v), T_(o), T_(iv), T_(ih))
    v, m, mu, var = _wagg_inputs(rng, 2, 2, 4)
    wagg_ops.window_agg(T_(v), T_(m), T_(mu), T_(var))
    a = torch.ones((2, 1, 3))
    rglru_ops.rglru_scan(a, a, torch.zeros((2, 3)))
    hz_ops.harmonize(torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3)),
                     torch.ones((1, 2, 3), dtype=torch.bool),
                     torch.zeros((1,)), tick_s=1.0, n_ticks=2)
    q, kv = torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 1, 16))
    fa_ops.flash_attention(q, kv, kv)
    assert (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES,
            hz_ops.LAUNCHES, fa_ops.LAUNCHES) == before
    assert hz_ops.LAUNCHES_BY_IMPL == by_impl
