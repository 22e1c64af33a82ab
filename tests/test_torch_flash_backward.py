"""The flash-attention gradient on the CPU: the chunked plain versions
(``attention_lse_ref``, ``attention_backward_ref``) that the gradient
kernel is held to on the card, against autograd through ``attention_ref``
and against the JAX package's ``blockwise_attention`` differentiated by
JAX; and the contract that ``FlashAttentionFn.backward`` never makes an
(Sq, Skv) tensor.

Bounds:
  * the plain backward against autograd through ``attention_ref``, which
    recomputes its own softmax statistics: elementwise within
    ``ref.backward_error_bound(..., same_stats=False)``, derived in its
    docstring from float32's unit roundoff u = 2^-24 and gamma(n) =
    n u / (1 - n u) over each sum and dot product: the D-term scores,
    the Skv-term row sums behind the logsumexp that the plain version's
    p = exp(s - lse) rewrite reads instead of exp(s - m) / l (its error
    enters p relatively), the D-term dp and delta (delta reads the
    forward's output, rounded to a 16-bit input type: u_in |out|), the
    G Sq-term sums of dv and dk and the Skv-term sum of dq; both sides
    are bounded against the exact value and the bound is their sum. A
    16-bit gradient is rounded once on each side: 2 u_in (|ref| + the
    float32 bound), plus twice half the type's subnormal spacing. The bound
    is worst case (no cancellation of rounding errors is assumed); in
    float32 it stays under 1e-2 of each gradient's largest magnitude at
    these sizes, far below what a dropped tile or a wrong mask moves;
  * against the JAX package (float32 both sides, another order of sums:
    XLA's online softmax over kv chunks against the plain version's
    chunks): ``GRAD_REL`` = 1e-4 of each gradient's largest magnitude,
    ``tests/test_torch_lm_train.py``'s bound for the port's gradients
    against JAX's, also for the emulated tf32 instance;
  * the emulated kernel instances against the chunked plain backward:
    ``backward_error_bound(same_stats=True)`` with the instance's
    ``split`` (True: the wgmma instance's 16-bit hi/lo halves of P and dS;
    "tf32": the tf32 instance's TF32 halves of every operand, derived in
    the bound's docstring), and a negative control for each split (one
    16-bit rounding of P and dS; one TF32 pass) that exceeds it;
  * the chunked forward up to ``Q_CHUNK`` rows runs ``attention_ref``'s
    ops and equals it bit for bit; above, each chunk is those ops on its
    rows, within 1e-6 (max abs) of the whole pass (torch's CPU matmul may
    block a longer product otherwise); its logsumexp within 1e-5 of
    ``torch.logsumexp`` over the masked float32 scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.models.layers import blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.layers import FlashAttentionFn, blockwise_attention

GRAD_REL = 1e-4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _inputs(rng, B, Sq, Skv, H, Hkv, D, dtype, softcap=0.0):
    mk = lambda *shape: torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32))
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    if softcap:
        q = q * 4          # scores in the tens: the cap changes them
    dout = mk(B, Sq, H, D)
    return tuple(t.to(dtype) for t in (q, k, v, dout))


def _autograd_ref(q, k, v, dout, **kw):
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa_ref.attention_ref(qa, ka, va, **kw)
    return torch.autograd.grad(out, (qa, ka, va), dout)


# B, Sq, Skv, H, Hkv, D, window, softcap, q_offset, dtype: below and above
# Q_CHUNK = 512 (two chunks, the second short), GQA and not, offsets
CASES = [
    (2, 40, 40, 4, 2, 16, 0, 0.0, 0, "float32"),
    (2, 40, 40, 4, 4, 16, 9, 0.0, 0, "float32"),
    (1, 30, 70, 4, 2, 16, 0, 5.0, 40, "float32"),
    (1, 600, 600, 4, 2, 16, 0, 0.0, 0, "float32"),
    (1, 600, 700, 2, 2, 24, 37, 3.0, 100, "float32"),
    (1, 530, 530, 4, 1, 20, 200, 0.0, 0, "float32"),
    (2, 40, 40, 4, 2, 16, 0, 0.0, 0, "bfloat16"),
    (1, 600, 600, 4, 1, 16, 0, 5.0, 0, "bfloat16"),
    (1, 300, 650, 4, 2, 8, 100, 0.0, 350, "float16"),
    (1, 600, 600, 2, 2, 32, 0, 0.0, 0, "float16"),
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window,softcap,off,dt", CASES)
def test_plain_backward_against_autograd_through_plain(
        rng, B, Sq, Skv, H, Hkv, D, window, softcap, off, dt):
    dtype = DTYPES[dt]
    q, k, v, dout = _inputs(rng, B, Sq, Skv, H, Hkv, D, dtype, softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    got = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, **kw)
    want = _autograd_ref(q, k, v, dout, **kw)
    bounds = fa_ref.backward_error_bound(q, k, v, out, dout, lse, **kw,
                                         ref=want)
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.double() - w.double()).abs()
        assert bool((err <= b).all()), (
            f"{name}: {float((err - b).max())} over the bound")
        if dtype == torch.float32:
            assert float(b.max()) < 1e-2 * float(w.abs().max()), name


def test_plain_backward_sees_a_dropped_key(rng):
    """The bound is tight enough to catch one key's term dropped from dv."""
    q, k, v, dout = _inputs(rng, 1, 64, 64, 2, 1, 16, torch.float32)
    out, lse = fa_ref.attention_lse_ref(q, k, v)
    _, _, dv = fa_ref.attention_backward_ref(q, k, v, out, dout, lse)
    want = _autograd_ref(q, k, v, dout)
    bound = fa_ref.backward_error_bound(q, k, v, out, dout, lse)[2]
    broken = dv.clone()
    broken[0, 40] = 0.0
    err = (broken.double() - want[2].double()).abs()
    assert not bool((err <= bound).all())


@pytest.mark.parametrize("Sq,Skv,off,window,softcap", [
    (24, 24, 0, 0, 0.0), (20, 33, 13, 7, 0.0), (12, 12, 0, 0, 3.0)])
def test_plain_backward_against_jax_blockwise_attention(rng, Sq, Skv, off,
                                                        window, softcap):
    """The port's ``blockwise_attention`` (``FlashAttentionFn``: on the CPU
    the chunked plain forward and backward) against ``jax.vjp`` of the
    reference's ``blockwise_attention``, float32, GQA with 2 q heads a kv
    head, at a query offset and with small chunks on the JAX side."""
    B, Hkv, G, D = 2, 2, 2, 16
    mk = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)
    q, k, v = mk(B, Sq, Hkv, G, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    if softcap:
        q = q * 4
    dout = mk(B, Sq, Hkv, G, D)
    qpos = np.broadcast_to(off + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv))

    def jfn(q, k, v):
        return jax_blockwise(q, k, v, q_positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kpos),
                             kv_valid=jnp.ones((B, Skv), bool), window=window,
                             softcap=softcap, q_chunk=8, kv_chunk=16)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = blockwise_attention(tq, tk, tv, window=window, softcap=softcap,
                              q_offset=off)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("Sq,off,window,softcap",
                         [(40, 0, 0, 0.0), (1100, 0, 0, 0.0),
                          (700, 200, 150, 4.0)])
def test_lse_forward_against_whole_pass(rng, Sq, off, window, softcap):
    Skv = Sq + off
    q, k, v, _ = _inputs(rng, 1, Sq, Skv, 4, 2, 16, torch.float32, softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    whole = fa_ref.attention_ref(q, k, v, **kw)
    assert out.is_contiguous() and lse.shape == (1, 4, Sq)
    if Sq <= fa_ref.Q_CHUNK:
        assert torch.equal(out, whole)
    else:
        assert float((out - whole).abs().max()) <= 1e-6
    s = torch.einsum("bqhd,bkhd->bhqk", q / 4.0,
                     k.repeat_interleave(2, dim=2))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = off + torch.arange(Sq)[:, None]
    j = torch.arange(Skv)[None, :]
    mask = (i >= j) & ((i - j < window) if window else True)
    want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), -1)
    assert float((lse - want).abs().max()) <= 1e-5


def test_wrapper_takes_lse_and_refuses_bad_shapes():
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.full((1, 2, 8), float("nan"))
    out = fa_ops.flash_attention(q, q, q, lse=lse)
    assert torch.equal(out, fa_ops.flash_attention(q, q, q))
    assert bool(torch.isfinite(lse).all())
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention(q, q, q, lse=torch.zeros((1, 8, 2)))
    with pytest.raises(TypeError, match="lse"):
        fa_ops.flash_attention(q, q, q, lse=lse.double())
    grads = fa_ops.flash_attention_backward(q, q, q, out, q, lse)
    assert [g.shape for g in grads] == [q.shape] * 3
    with pytest.raises(ValueError, match="dout"):
        fa_ops.flash_attention_backward(q, q, q, out, q[:, :4], lse)
    with pytest.raises(ValueError, match="offset"):
        fa_ops.flash_attention_backward(q, q, q, out, q, lse, q_offset=1)


def test_flash_fn_with_no_query_rows():
    """A context-parallel shard with no rows (S < the model axis): the
    forward and the gradient take Sq = 0, the keys' gradients zero."""
    q = torch.zeros((1, 0, 2, 8), requires_grad=True)
    k, v = (torch.randn((1, 4, 1, 8)).requires_grad_() for _ in range(2))
    out = FlashAttentionFn.apply(q, k, v, 0, 0.0, 4)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert out.shape == q.shape and dq.shape == q.shape
    assert not dk.any() and not dv.any()


class _Made(TorchDispatchMode):
    """Every tensor an op makes: (op, shape, elements)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made += [(str(func), tuple(t.shape), t.numel())
                      for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


def test_backward_holds_no_score_matrix(rng, monkeypatch):
    """``FlashAttentionFn.backward`` at (1, 2048, 4 q / 2 kv heads, 16)
    with 256-row chunks: no tensor it makes has Sq * Skv elements per
    (batch row, q head), the size of one head's score matrix; the largest
    is one chunk's scores. (Autograd through ``attention_ref``, the
    backward before the chunked one, makes (1, 2, 2, 2048, 2048) scores.)"""
    monkeypatch.setattr(fa_ref, "Q_CHUNK", 256, raising=False)
    B, S, H, Hkv, D = 1, 2048, 4, 2, 16
    q, k, v, dout = _inputs(rng, B, S, S, H, Hkv, D, torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = FlashAttentionFn.apply(q, k, v, 0, 0.0)
    with _Made() as rec:
        grads = torch.autograd.grad(out, (q, k, v), dout)
    assert all(g.shape == t.shape for g, t in zip(grads, (q, k, v)))
    assert rec.made, "the dispatch mode saw no op of the backward"
    per_head = [(op, shape, n / (B * H)) for op, shape, n in rec.made]
    over = [x for x in per_head if x[2] >= S * S]
    assert not over, f"tensors of a whole score matrix per head: {over}"
    assert max(n for _, _, n in per_head) == 256 * S


def _emulate_kernels(q, k, v, out, dout, lse, *, window, softcap, q_offset):
    """The gradient kernels' tile loops (csrc/flash_attention_bwd.cu) in
    float64 numpy: the dK/dV blocks (a q head, 64 keys, a group of 64 or
    128 output columns) over the q blocks of 64 rows from the first that
    sees the keys to the last a window lets see them, each q head's share
    of dK and dV then summed over its kv head's q heads in order, the
    dQ blocks (64 rows) over the key blocks their rows see, each tile's
    mask and P = exp(S - lse), dS = P (dP - delta) (1 - t^2); rows past Sq
    and keys past Skv staged as zeros and never stored."""
    q, k, v, out, dout = (t.double().numpy() for t in (q, k, v, out, dout))
    lse = lse.double().numpy()
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(D)
    kb = 64
    DW = 64 if D <= 64 else 128
    delta = (dout * out).sum(-1).transpose(0, 2, 1)        # (B, H, Sq)
    Dp = -(-D // DW) * DW          # columns past D read as zeros
    q, k, v, dout = (np.pad(x, [(0, 0)] * 3 + [(0, Dp - D)])
                     for x in (q, k, v, dout))

    def pad(x, r0, n):
        t = np.zeros((kb,) + x.shape[1:])
        t[:max(0, min(kb, n - r0))] = x[r0:r0 + kb]
        return t

    def tile(b, h, r0, k0):
        hk = h // G
        Q = pad(q[b, :, h], r0, Sq) * scale
        K, V = pad(k[b, :, hk], k0, Skv), pad(v[b, :, hk], k0, Skv)
        dO = pad(dout[b, :, h], r0, Sq)
        s, dp = Q @ K.T, dO @ V.T
        dcap = 1.0
        if softcap:
            t = np.tanh(s / softcap)
            s, dcap = t * softcap, 1 - t * t
        row = r0 + np.arange(kb)[:, None]
        pos, kpos = q_offset + row, k0 + np.arange(kb)[None, :]
        ok = (row < Sq) & (kpos < Skv) & (kpos <= pos)
        if window:
            ok &= pos - kpos < window
        lrow, drow = pad(lse[b, h, :, None], r0, Sq), pad(
            delta[b, h, :, None], r0, Sq)
        p = np.where(ok, np.exp(np.where(ok, s - lrow, 0.0)), 0.0)
        return Q, K, dO, p, p * (dp - drow) * dcap

    dq = np.zeros(q.shape[:3] + (D,))
    part_k, part_v = (np.zeros((B, Skv, H, D)) for _ in range(2))
    for b in range(B):
        for h in range(H):
            for c in range(0, D, DW):
                for k0 in range(0, Skv, kb):
                    k_last = min(k0 + kb, Skv) - 1
                    r_first = max(0, k0 - q_offset) // kb * kb
                    r_end = (min(Sq, k_last + window - q_offset) if window
                             else Sq)
                    akk, avv = np.zeros((kb, DW)), np.zeros((kb, DW))
                    for r0 in range(r_first, r_end, kb):
                        Q, _, dO, p, ds = tile(b, h, r0, k0)
                        avv += p.T @ dO[:, c:c + DW]
                        akk += ds.T @ Q[:, c:c + DW]
                    n = min(kb, Skv - k0)
                    w = min(DW, D - c)
                    part_k[b, k0:k0 + n, h, c:c + w] = akk[:n, :w]
                    part_v[b, k0:k0 + n, h, c:c + w] = avv[:n, :w]
        for h in range(H):
            for c in range(0, D, DW):
                for r0 in range(0, Sq, kb):
                    p0 = q_offset + r0
                    q_last = q_offset + min(r0 + kb, Sq) - 1
                    k_begin = (max(0, p0 - window + 1) // kb * kb if window
                               else 0)
                    acc = np.zeros((kb, DW))
                    for k0 in range(k_begin, q_last + 1, kb):
                        _, K, _, _, ds = tile(b, h, r0, k0)
                        acc += ds @ K[:, c:c + DW]
                    n, w = min(kb, Sq - r0), min(DW, D - c)
                    dq[b, r0:r0 + n, h, c:c + w] = acc[:n, :w] * scale
    dk, dv = (x.reshape(B, Skv, Hkv, G, D).sum(3) for x in (part_k, part_v))
    return tuple(torch.from_numpy(x) for x in (dq, dk, dv))


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window,softcap,off", [
    (1, 150, 150, 4, 2, 20, 0, 0.0, 0),
    (2, 70, 200, 2, 1, 64, 50, 3.0, 130),
    (1, 100, 300, 4, 4, 130, 0, 0.0, 200),
    (1, 200, 200, 2, 1, 36, 64, 0.0, 0),
    (1, 60, 130, 4, 2, 8, 20, 5.0, 64)])
def test_kernel_tile_order_emulated(rng, B, Sq, Skv, H, Hkv, D, window,
                                    softcap, off):
    """The gradient kernels' block and tile ranges, masks and column groups,
    emulated in float64 (``_emulate_kernels``), against the chunked plain
    backward within ``backward_error_bound(same_stats=True)``: a tile the
    loops skipped or a row they counted twice moves a gradient by whole
    terms, far past the bound."""
    q, k, v, dout = _inputs(rng, B, Sq, Skv, H, Hkv, D, torch.float32,
                            softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    got = _emulate_kernels(q, k, v, out, dout, lse, **kw)
    want = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, **kw)
    bounds = fa_ref.backward_error_bound(q, k, v, out, dout, lse, **kw,
                                         same_stats=True)
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        err = (g - w.double()).abs()
        assert bool((err <= b).all()), (name, float((err - b).max()))


def _halves(x, dtype, halves=True):
    """float64 x as the wgmma instance feeds it to a product: rounded to
    float32 (its p and ds are float32), then as hi = E(x) and lo = E(x - hi)
    in the 16-bit type E, returned as hi + lo in float64 (``halves=False``:
    hi alone, x rounded once to E)."""
    x32 = torch.from_numpy(x.astype(np.float32))
    hi = x32.to(dtype)
    if not halves:
        return hi.double().numpy()
    lo = (x32 - hi.float()).to(dtype)
    return hi.double().numpy() + lo.double().numpy()


def _emulate_wgmma(q, k, v, out, dout, lse, *, window, softcap, q_offset,
                   halves=True):
    """The gradient's wgmma instance (csrc/flash_attention_bwd_sm90.cu) in
    float64 numpy: the narrowest instance width DW (64, 128 or 256) that
    holds D, columns past D zero; the dK/dV CTAs (a q head, 128 keys as two
    warpgroups of 64, a group of 128 output columns at DW = 256) over q
    tiles of 64 rows (32 at DW 128 and 256) from the first that sees the
    block's keys to the last a window lets see them, a warpgroup skipping
    the tiles its keys cannot see; the dQ CTAs (128 rows as two warpgroups)
    over key tiles of 64 (32 at DW 256) from the window's first to the
    rows' last; per tile S = Q K^T times the scale, the softcap, the mask,
    P = exp(S - lse), dS = P (dP - delta) (1 - t^2); P and dS enter the
    products as float32 split into 16-bit hi and lo halves (``_halves``);
    dK times the scale in each q head's float32 share, the shares summed
    over a kv head's q heads in order, dQ times the scale once. Returns
    float64 (dq, dk, dv), unrounded."""
    dtype = q.dtype
    q, k, v, out, dout = (t.double().numpy() for t in (q, k, v, out, dout))
    lse = lse.double().numpy()
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(D)
    DW = next(w for w in (64, 128, 256) if D <= w)
    DO = min(DW, 128)
    bs_kv, bs_q = (32 if DW >= 128 else 64), (32 if DW == 256 else 64)
    delta = (dout * out).sum(-1).transpose(0, 2, 1)        # (B, H, Sq)
    q, k, v, dout = (np.pad(x, [(0, 0)] * 3 + [(0, DW - D)])
                     for x in (q, k, v, dout))

    def rows_of(x, idx, n):
        """rows idx of x, zeros at and past n (TMA's fill)"""
        return np.where((idx < n)[:, None], x[np.minimum(idx, n - 1)], 0.0)

    def tile(b, h, rows, keys):
        hk = h // G
        Q, dO = rows_of(q[b, :, h], rows, Sq), rows_of(dout[b, :, h], rows, Sq)
        K, V = rows_of(k[b, :, hk], keys, Skv), rows_of(v[b, :, hk], keys, Skv)
        s, dcap = (Q @ K.T) * scale, 1.0
        if softcap:
            t = np.tanh(s / softcap)
            s, dcap = t * softcap, 1 - t * t
        pos, kpos = q_offset + rows[:, None], keys[None, :]
        ok = (rows[:, None] < Sq) & (kpos < Skv) & (kpos <= pos)
        if window:
            ok &= pos - kpos < window
        row_l = np.where(rows < Sq, lse[b, h, np.minimum(rows, Sq - 1)], 0.0)
        row_d = np.where(rows < Sq, delta[b, h, np.minimum(rows, Sq - 1)],
                         0.0)
        p = np.where(ok, np.exp(np.where(ok, s - row_l[:, None], 0.0)), 0.0)
        ds = p * (dO @ V.T - row_d[:, None]) * dcap
        return Q, K, dO, _halves(p, dtype, halves), _halves(ds, dtype, halves)

    dq = np.zeros((B, Sq, H, D))
    part_k, part_v = np.zeros((B, Skv, H, D)), np.zeros((B, Skv, H, D))
    for b in range(B):
        for h in range(H):
            for k0 in range(0, Skv, 128):
                k_last = min(k0 + 128, Skv) - 1
                r_first = max(0, k0 - q_offset) // bs_kv * bs_kv
                r_end = (min(Sq, k_last + window - q_offset) if window
                         else Sq)
                for c in range(0, DW, DO):
                    for wk in (k0, k0 + 64):               # warpgroups
                        keys = wk + np.arange(64)
                        akk, avv = np.zeros((64, DO)), np.zeros((64, DO))
                        for r0 in range(r_first, r_end, bs_kv):
                            lo, hi = q_offset + r0, q_offset + r0 + bs_kv - 1
                            if hi < wk or (window and lo - (wk + 63)
                                           >= window):
                                continue
                            Q, _, dO, p, ds = tile(b, h, r0 + np.arange(
                                bs_kv), keys)
                            avv += p.T @ dO[:, c:c + DO]
                            akk += ds.T @ Q[:, c:c + DO]
                        n = max(0, min(64, Skv - wk))
                        w = max(0, min(DO, D - c))
                        part_k[b, wk:wk + n, h, c:c + w] = scale * akk[:n, :w]
                        part_v[b, wk:wk + n, h, c:c + w] = avv[:n, :w]
            for q0 in range(0, Sq, 128):
                p0 = q_offset + q0
                q_last = q_offset + min(q0 + 128, Sq) - 1
                k_begin = (max(0, p0 - window + 1) // bs_q * bs_q if window
                           else 0)
                for wr in (q0, q0 + 64):                   # warpgroups
                    lo = q_offset + wr
                    acc = np.zeros((64, DW))
                    for k0 in range(k_begin, q_last + 1, bs_q):
                        if k0 > lo + 63 or (window and k0 + bs_q
                                            <= lo - window + 1):
                            continue
                        _, K, _, _, ds = tile(b, h, wr + np.arange(64),
                                              k0 + np.arange(bs_q))
                        acc += ds @ K
                    n = max(0, min(64, Sq - wr))
                    dq[b, wr:wr + n, h] = scale * acc[:n, :D]
    dk, dv = (x.reshape(B, Skv, Hkv, G, D).sum(3) for x in (part_k, part_v))
    return tuple(torch.from_numpy(x) for x in (dq, dk, dv))


def _wgmma_over_bound(rng, B, Sq, Skv, H, Hkv, D, window, softcap, off,
                      dt, halves=True):
    """The emulated wgmma instance against the chunked plain backward: the
    largest |error| over ``backward_error_bound(same_stats=True,
    split=True)`` over dq, dk and dv."""
    q, k, v, dout = _inputs(rng, B, Sq, Skv, H, Hkv, D, DTYPES[dt], softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    got = _emulate_wgmma(q, k, v, out, dout, lse, halves=halves, **kw)
    want = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, **kw)
    bounds = fa_ref.backward_error_bound(q, k, v, out, dout, lse, **kw,
                                         same_stats=True, split=True,
                                         ref=want)
    return max(float(((g - w.double()).abs() / b).max())
               for g, w, b in zip(got, want, bounds))


# test_kernel_tile_order_emulated's cases in 16 bits, D = 256 (two dK/dV
# column groups) and offsets off the 128-row blocks
WGMMA_CASES = [
    (1, 150, 150, 4, 2, 20, 0, 0.0, 0, "bfloat16"),
    (2, 70, 200, 2, 1, 64, 50, 3.0, 130, "bfloat16"),
    (1, 100, 300, 4, 4, 130, 0, 0.0, 200, "float16"),
    (1, 200, 200, 2, 1, 36, 64, 0.0, 0, "bfloat16"),
    (1, 60, 130, 4, 2, 8, 20, 5.0, 64, "float16"),
    (1, 140, 330, 2, 1, 256, 0, 3.0, 190, "bfloat16"),
    (1, 260, 260, 4, 1, 128, 100, 0.0, 0, "float16")]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window,softcap,off,dt",
                         WGMMA_CASES)
def test_wgmma_instance_emulated(rng, B, Sq, Skv, H, Hkv, D, window,
                                 softcap, off, dt):
    """The wgmma instance's block and tile ranges, warpgroup skips, column
    groups, hi/lo splits and scale placement, emulated in float64
    (``_emulate_wgmma``), within ``backward_error_bound(same_stats=True,
    split=True)`` of the chunked plain backward: a tile dropped or counted
    twice moves a gradient by whole terms, far past the bound."""
    assert _wgmma_over_bound(rng, B, Sq, Skv, H, Hkv, D, window, softcap,
                             off, dt) <= 1.0


def test_wgmma_split_is_needed(rng):
    """The negative control of the hi/lo split: at (1, 64, 64, 2 q / 1 kv
    heads, D 16) in bfloat16, P and dS each rounded once to bfloat16 put
    the emulated instance past the bound (the bound allows the halves'
    u_in^2 = 2^-16, a single rounding moves each term by up to 2^-9)."""
    case = (1, 64, 64, 2, 1, 16, 0, 0.0, 0, "bfloat16")
    assert _wgmma_over_bound(rng, *case) <= 1.0
    assert _wgmma_over_bound(rng, *case, halves=False) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [1, 8, 36, 48, 64, 80, 96, 128, 200, 256, 320,
                               1000])
def test_backward_impl_for_every_dtype_and_head_dim(dtype, D):
    """The gradient's static instance: wgmma exactly where the forward runs
    on the tensor cores (bfloat16 and float16 at D % 8 == 0 up to 256),
    tf32 for every other (dtype, D) up to D = 128 (float32 at every such
    D), the FMA kernels above; each instance names four launches, the sum
    kernel shared, the first the delta kernel (the tf32 instance's split
    pass computes delta too)."""
    if dtype != torch.float32 and D % 8 == 0 and D <= 256:
        want = "wgmma"
    else:
        want = "tf32" if D <= 128 else "fma"
    assert fa_ops.bwd_impl_for(dtype, D) == want
    assert (fa_ops.impl_for(dtype, D) == "wgmma") == (want == "wgmma")
    kernels = fa_ops.BWD_KERNELS[want]
    assert len(kernels) == 4
    assert kernels[0] == ("split_tf32" if want == "tf32" else "dot")
    assert kernels[2] == "dkdv_sum"
    assert set(kernels) <= set(fa_ops.LAUNCHES_BWD_BY_KERNEL)
    assert fa_ops.BWD_SPLIT[want] == {"wgmma": True, "tf32": "tf32",
                                      "fma": False}[want]


def test_split_bound_needs_a_16_bit_type(rng):
    q, k, v, dout = _inputs(rng, 1, 8, 8, 2, 1, 8, torch.float32)
    out, lse = fa_ref.attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="16-bit"):
        fa_ref.backward_error_bound(q, k, v, out, dout, lse, split=True)


def _rna(x32):
    """float32 numpy values rounded to TF32 as ``cvt.rna`` rounds them (to
    nearest, ties away from zero): 0x1000 added to the bits, the low 13
    cleared."""
    bits = np.ascontiguousarray(x32, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_split(x):
    """float64 x as the tf32 instance holds it (float32) split into TF32
    halves big = tf32(x) and small = tf32(x - big), as float64."""
    x32 = np.asarray(x, dtype=np.float32)
    big = _rna(x32)
    small = _rna(x32 - big)               # x32 - big is exact in float32
    return big.astype(np.float64), small.astype(np.float64)


def _prod3(a, b, passes=3):
    """a @ b of two split operands ((big, small) each) as the instance's
    dV, dK and dQ products take it: big big + big small + small big
    (``passes=1``: big big alone)."""
    out = a[0] @ b[0]
    if passes == 3:
        out = out + a[0] @ b[1] + a[1] @ b[0]
    return out


def _prod4(a, b, passes=3):
    """a @ b of two split operands as the instance's S and dP take it: all
    four products of the halves, (big + small) (big + small) (``passes=1``:
    big big alone)."""
    if passes == 1:
        return a[0] @ b[0]
    return (a[0] + a[1]) @ (b[0] + b[1])


def _emulate_tf32(q, k, v, out, dout, lse, *, window, softcap, q_offset,
                  passes=3):
    """The gradient's tf32 instance (csrc/flash_attention_bwd_tf32.cu) in
    float64 numpy: the split pass (delta, and q, k, v, dout as float32 split
    into TF32 halves by ``cvt.rna``, padded with zeros to the instance
    width DW, 64 or 128, the narrowest that holds D); the dK/dV CTAs (a q
    head, 64 keys, every output column) over q tiles of BS rows (32 at DW
    64, 16 at DW 128) from the first that sees
    the block's keys to the last a window lets see them, skipping the tiles
    whose rows cannot see its keys, the tiles taken in turn by two
    warpgroups whose sums are added at the end (the first's first); the dQ
    CTAs (64 rows) over key tiles of BS from the window's first to the
    rows' last, likewise; per tile S = Q K^T (all four TF32 products of the
    halves) times the scale, the softcap, the mask, P = exp(S - lse), dP
    likewise, dS = P (dP - delta) (1 - t^2); P and dS as float32 split into
    TF32 halves for dV += P^T dO, dK += dS^T Q and dQ += dS K (three
    products: big big, big small, small big); dK times the scale in
    each q head's share, the shares summed over a kv head's q heads in
    order, dQ times the scale once. ``passes=1`` takes every product as
    big big alone. Returns float64 (dq, dk, dv), unrounded."""
    q, k, v, out, dout = (t.double().numpy() for t in (q, k, v, out, dout))
    lse = lse.double().numpy()
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(D)
    DW = 64 if D <= 64 else 128          # the narrowest width holding D
    BS = 32 if DW == 64 else 16
    delta = (dout * out).sum(-1).transpose(0, 2, 1)        # (B, H, Sq)
    pad = lambda x: np.pad(x, [(0, 0)] * 3 + [(0, DW - D)])
    qs, ks, vs, dos = (_tf32_split(pad(x)) for x in (q, k, v, dout))

    def rows_of(x, b, h, idx, n):
        """rows idx of a split tensor's head h, zeros at and past n"""
        return tuple(np.where((idx < n)[:, None],
                              y[b, np.minimum(idx, n - 1), h], 0.0)
                     for y in x)

    def tile(b, h, rows, keys):
        hk = h // G
        Q, dO = rows_of(qs, b, h, rows, Sq), rows_of(dos, b, h, rows, Sq)
        K, V = rows_of(ks, b, hk, keys, Skv), rows_of(vs, b, hk, keys, Skv)
        T = lambda x: tuple(y.T for y in x)
        s, dcap = _prod4(Q, T(K), passes) * scale, 1.0
        if softcap:
            t = np.tanh(s / softcap)
            s, dcap = t * softcap, 1 - t * t
        pos, kpos = q_offset + rows[:, None], keys[None, :]
        ok = (rows[:, None] < Sq) & (kpos < Skv) & (kpos <= pos)
        if window:
            ok &= pos - kpos < window
        inside = np.minimum(rows, Sq - 1)
        row_l = np.where(rows < Sq, lse[b, h, inside], 0.0)
        row_d = np.where(rows < Sq, delta[b, h, inside], 0.0)
        p = np.where(ok, np.exp(np.where(ok, s - row_l[:, None], 0.0)), 0.0)
        ds = p * (_prod4(dO, T(V), passes) - row_d[:, None]) * dcap
        return Q, K, dO, _tf32_split(p), _tf32_split(ds)

    def in_turns(tiles, step):
        """the two warpgroups' sums over alternate tiles, the first's
        first"""
        acc = [0.0, 0.0]
        for t, x in enumerate(tiles):
            if x is not None:
                acc[t % 2] = acc[t % 2] + step(x)
        return acc[0] + acc[1]

    dq = np.zeros((B, Sq, H, D))
    part_k, part_v = np.zeros((B, Skv, H, D)), np.zeros((B, Skv, H, D))
    for b in range(B):
        for h in range(H):
            for k0 in range(0, Skv, 64):
                k_last = min(k0 + 64, Skv) - 1
                r_first = max(0, k0 - q_offset) // BS * BS
                r_end = (min(Sq, k_last + window - q_offset) if window
                         else Sq)
                keys = k0 + np.arange(64)
                n = min(64, Skv - k0)
                tiles = []
                for r0 in range(r_first, r_end, BS):
                    lo, hi = q_offset + r0, q_offset + r0 + BS - 1
                    live = hi >= k0 and (not window
                                         or lo - (k0 + 63) < window)
                    tiles.append(tile(b, h, r0 + np.arange(BS), keys)
                                 if live else None)
                T = lambda x: tuple(y.T for y in x)
                dv_ = in_turns(tiles, lambda x: _prod3(T(x[3]), x[2],
                                                       passes))
                dk_ = in_turns(tiles, lambda x: _prod3(T(x[4]), x[0],
                                                       passes))
                part_k[b, k0:k0 + n, h] = (
                    scale * (dk_ + np.zeros((64, DW))))[:n, :D]
                part_v[b, k0:k0 + n, h] = (dv_ + np.zeros((64, DW)))[:n, :D]
            for q0 in range(0, Sq, 64):
                p0 = q_offset + q0
                q_last = q_offset + min(q0 + 64, Sq) - 1
                k_begin = max(0, p0 - window + 1) // BS * BS if window else 0
                rows = q0 + np.arange(64)
                tiles = []
                for k0 in range(k_begin, q_last + 1, BS):
                    live = k0 <= p0 + 63 and (not window
                                              or k0 + BS > p0 - window + 1)
                    tiles.append(tile(b, h, rows, k0 + np.arange(BS))
                                 if live else None)
                acc = in_turns(tiles, lambda x: _prod3(x[4], x[1], passes))
                n = min(64, Sq - q0)
                dq[b, q0:q0 + n, h] = (scale * acc)[:n, :D]
    dk, dv = (x.reshape(B, Skv, Hkv, G, D).sum(3) for x in (part_k, part_v))
    return tuple(torch.from_numpy(x) for x in (dq, dk, dv))


def _tf32_over_bound(rng, B, Sq, Skv, H, Hkv, D, window, softcap, off, dt,
                     passes=3):
    """The emulated tf32 instance against the chunked plain backward: the
    largest |error| over ``backward_error_bound(same_stats=True,
    split="tf32")`` over dq, dk and dv."""
    q, k, v, dout = _inputs(rng, B, Sq, Skv, H, Hkv, D, DTYPES[dt], softcap)
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    got = _emulate_tf32(q, k, v, out, dout, lse, passes=passes, **kw)
    want = fa_ref.attention_backward_ref(q, k, v, out, dout, lse, **kw)
    bounds = fa_ref.backward_error_bound(q, k, v, out, dout, lse, **kw,
                                         same_stats=True, split="tf32",
                                         ref=want)
    return max(float(((g - w.double()).abs() / b).max())
               for g, w, b in zip(got, want, bounds))


# float32 at D 20, 64, 100 and 128 (DW 64 and 128), windows, softcaps and
# offsets off the 64-row blocks; 16-bit at head dims off the wgmma
# instance's (D % 8 != 0)
TF32_CASES = [
    (1, 150, 150, 4, 2, 20, 0, 0.0, 0, "float32"),
    (2, 70, 200, 2, 1, 64, 50, 3.0, 130, "float32"),
    (1, 100, 300, 4, 4, 100, 0, 0.0, 200, "float32"),
    (1, 260, 260, 4, 1, 128, 100, 0.0, 0, "float32"),
    (1, 60, 130, 4, 2, 8, 20, 5.0, 64, "float32"),
    (1, 200, 200, 2, 1, 36, 64, 0.0, 0, "bfloat16"),
    (1, 97, 140, 4, 1, 20, 16, 0.0, 40, "float16")]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window,softcap,off,dt",
                         TF32_CASES)
def test_tf32_instance_emulated(rng, B, Sq, Skv, H, Hkv, D, window, softcap,
                                off, dt):
    """The tf32 instance's block and tile ranges, skips, the turns of its
    two warpgroups, split pass and TF32 halves (``cvt.rna``)
    of every operand, emulated in float64 (``_emulate_tf32``), within
    ``backward_error_bound(same_stats=True, split="tf32")`` of the chunked
    plain backward: a tile dropped or counted twice moves a gradient by
    whole terms, far past the bound."""
    assert _tf32_over_bound(rng, B, Sq, Skv, H, Hkv, D, window, softcap,
                            off, dt) <= 1.0


# the negative control's cases: a small one, and qwen3-0.6b's heads (16 q
# over 8 kv, D 128) over 512 rows and keys, the path's float32 gradient
# (chip_smoke's path_f32) at a quarter of its length, where the bound's
# gamma(3 n) terms are wider
TF32_CONTROL_CASES = [
    (1, 64, 64, 2, 1, 16, 0, 0.0, 0, "float32"),
    (1, 512, 512, 16, 8, 128, 0, 0.0, 0, "float32")]


@pytest.mark.parametrize("case", TF32_CONTROL_CASES)
def test_tf32_three_passes_are_needed(rng, case):
    """The negative control of the three TF32 passes: in float32, every
    product taken as big big alone (one TF32 pass, each operand rounded
    once to TF32: ~2^-11 a term) puts the emulated instance past the
    bound, which the three passes hold, at a small shape and at the
    path's heads."""
    assert _tf32_over_bound(rng, *case) <= 1.0
    assert _tf32_over_bound(rng, *case, passes=1) > 1.0


def test_tf32_instance_against_jax_blockwise_attention(rng):
    """The emulated tf32 instance against ``jax.vjp`` of the reference's
    ``blockwise_attention``, float32, GQA with 2 q heads a kv head, at a
    query offset, a window and a softcap: within ``GRAD_REL`` of each
    gradient's largest magnitude, the bound of the plain backward's JAX
    test above."""
    B, Hkv, G, D, Sq, Skv, off, window, softcap = 2, 2, 2, 16, 40, 60, 20, \
        17, 3.0
    mk = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)
    q, k, v = mk(B, Sq, Hkv, G, D) * 4, mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    dout = mk(B, Sq, Hkv, G, D)
    qpos = np.broadcast_to(off + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv))

    def jfn(q, k, v):
        return jax_blockwise(q, k, v, q_positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kpos),
                             kv_valid=jnp.ones((B, Skv), bool), window=window,
                             softcap=softcap, q_chunk=8, kv_chunk=16)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq = torch.from_numpy(q.reshape(B, Sq, Hkv * G, D))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tdo = torch.from_numpy(dout.reshape(B, Sq, Hkv * G, D))
    kw = dict(window=window, softcap=softcap, q_offset=off)
    out, lse = fa_ref.attention_lse_ref(tq, tk, tv, **kw)
    got = _emulate_tf32(tq, tk, tv, out, tdo, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, jgrads):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)
