"""Plain PyTorch versions of the flash-attention kernels (the forward is the
twin of ``repro.kernels.flash_attention.ref.attention_ref``).

:func:`attention_ref` materializes the full (Sq, Skv) score matrix and
repeats the forward kernel's arithmetic: inputs upcast to float32, q scaled
in float32 before the product, the tanh softcap before the mask, masked
scores at ``NEG_INF``, the row max floored at ``MAX_FLOOR`` and the
denominator at ``DENOM_FLOOR`` (the constants of
``src/repro/kernels/flash_attention/kernel.py``), p kept in float32 for the
PV product, and the result cast to q's dtype.

:func:`attention_lse_ref` and :func:`attention_backward_ref` are the plain
versions of what training needs, in chunks of ``Q_CHUNK`` query rows (the
reference's ``q_chunk`` in ``src/repro/models/layers.py``
``blockwise_attention``, whose gradient recomputes each chunk's scores),
so that no tensor holds (Sq, Skv) scores: the forward with each row's
logsumexp, and the gradient from that logsumexp.
:func:`backward_error_bound` is the elementwise bound two float32
computations of the gradient are held to.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
MAX_FLOOR = -1e29
DENOM_FLOOR = 1e-30
Q_CHUNK = 512          # query rows a chunk of the training versions


def _attend(q, k, v, window, softcap, scale, q_offset):
    """(out, m, denom) of the plain forward: out (B, Sq, H, D) in q's
    dtype; m and denom (B, Hkv, G, Sq, 1) float32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = q_offset + torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask &= (i - j) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True).clamp(min=MAX_FLOOR)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True).clamp(min=DENOM_FLOOR)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype), m, denom


def attention_ref(q, k, v, *, window: int = 0, softcap: float = 0.0,
                  scale=None, q_offset: int = 0):
    """Causal GQA attention, model layout: q (B, Sq, H, D); k, v
    (B, Skv, Hkv, D) with H % Hkv == 0, q head h reading kv head h // G.
    Query row i sits at position ``q_offset + i``, keys at 0..Skv-1
    (``q_offset + Sq <= Skv``; Sq = Skv at offset 0 is the whole causal
    pass). Returns (B, Sq, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return _attend(q, k, v, window, softcap, scale, q_offset)[0]


def attention_lse_ref(q, k, v, *, window: int = 0, softcap: float = 0.0,
                      scale=None, q_offset: int = 0):
    """:func:`attention_ref` and each row's logsumexp of its scores,
    ``m + log(denom)``, as float32 (B, H, Sq), computed ``Q_CHUNK`` query
    rows at a time: the largest tensor holds (B, H, Q_CHUNK, Skv) scores.
    Up to ``Q_CHUNK`` rows it runs :func:`attention_ref`'s ops as they are,
    so its output has their bits; the output is contiguous, as the
    backward takes it."""
    B, Sq, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    outs, lses = [], []
    for c0 in range(0, max(Sq, 1), Q_CHUNK):      # one (empty) chunk at Sq 0
        out, m, denom = _attend(q[:, c0:c0 + Q_CHUNK], k, v, window,
                                softcap, scale, q_offset + c0)
        outs.append(out)
        lses.append((m + torch.log(denom)).reshape(B, H, out.shape[1]))
    if len(outs) == 1:
        return outs[0].contiguous(), lses[0]
    return torch.cat(outs, 1), torch.cat(lses, 2)


def _chunk_keys(lo: int, hi: int, window: int):
    """The keys that query positions lo .. hi - 1 see: [k0, hi)."""
    return (max(0, lo - window + 1) if window else 0), hi


def attention_backward_ref(q, k, v, out, dout, lse, *, window: int = 0,
                           softcap: float = 0.0, scale=None,
                           q_offset: int = 0):
    """The gradient (dq, dk, dv) of :func:`attention_ref` at ``dout``, from
    its output ``out`` and its logsumexp ``lse`` ((B, H, Sq) float32, as
    :func:`attention_lse_ref` or the kernel's ``lse`` gives it), in
    ``Q_CHUNK`` query rows at a time against the keys each chunk sees. Per
    chunk, in float32: s = scale q k^T (softcapped as the forward),
    p = exp(s - lse) on the mask and 0 off it, dp = dout v^T,
    ds = p (dp - delta) with delta = sum_d dout out, times 1 - (s / cap)^2
    under a softcap; dv += p^T dout and dk += ds^T (scale q) accumulate in
    float32, the chunk's dq = scale ds k. Each is rounded once to its
    input's dtype. The largest tensor holds (B, H, Q_CHUNK, Skv) scores."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, Sq, Hkv, G, D)
    delta = (dout.float() * out.float()).sum(-1)                # (B, Sq, H)
    delta = delta.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    lse = lse.reshape(B, Hkv, G, Sq)
    dq = torch.empty((B, Sq, Hkv, G, D), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Skv, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, Sq, Q_CHUNK):
        c1 = min(Sq, c0 + Q_CHUNK)
        lo, hi = q_offset + c0, q_offset + c1
        k0, k1 = _chunk_keys(lo, hi, window)
        qc, doc = qf[:, c0:c1], dof[:, c0:c1]
        kc, vc = kf[:, k0:k1], vf[:, k0:k1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc)
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        i = torch.arange(lo, hi, device=q.device)[:, None]
        j = torch.arange(k0, k1, device=q.device)[None, :]
        mask = i >= j
        if window:
            mask &= (i - j) < window
        p = torch.where(mask, torch.exp(s - lse[..., c0:c1, None]), 0.0)
        del s
        ds = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
        ds = p * (ds - delta[..., c0:c1, None])
        if softcap:
            ds = ds * (1.0 - t * t)
            del t
        dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
        del p
        dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc)
        dq[:, c0:c1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kc)
        del ds
    dq = (dq * scale).reshape(B, Sq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_error_bound(q, k, v, out, dout, lse, *, window: int = 0,
                         softcap: float = 0.0, scale=None, q_offset: int = 0,
                         same_stats: bool = False, split: bool = False,
                         ref=None):
    """Elementwise bounds (dq, dk, dv), float64, on |a - b| for two float32
    computations a and b of this gradient from the same inputs, derived
    from the float32 unit roundoff u = 2^-24 and gamma(n) = n u / (1 - n u),
    the worst-case relative error of an n-term sum or dot product. Each
    side is bounded against the exact value, in float64 from the same
    inputs, and the bound is the sum of both sides' (2x one side's):

    * s = scale q.k over D terms: |ds| <= gamma(D + 2) (|scale q|.|k|)
      + 4u |s| (the softcap's tanh has slope <= 1 and rounds a few times);
    * with ``same_stats`` both sides read the same ``lse`` and ``out`` (the
      kernel against the plain chunked version) and compute p = exp(s -
      lse): relative error e_p = |ds| + u (|s| + |lse|) + 2u. Otherwise one
      side recomputes its statistics (autograd through
      :func:`attention_ref`: m, l = sum over the row's keys, p = exp(s -
      m) / l), so e_p gains the logsumexp's error: 2 max_row |ds| +
      u (max |s| + |m|) + gamma(Skv + 4) + u (|log l| + |lse|) + 2u;
    * dp = dout.v over D terms: gamma(D + 2) |dout|.|v|; delta = sum_d
      dout out over D terms: gamma(D + 2) |dout|.|out|, plus, without
      ``same_stats``, |dout|.|out - O| for the exact O = P v: a 16-bit
      ``out`` is rounded (its unit u_in |O|), and the forward's own error
      is (max e_p + gamma(Skv + 2) + u_in^2) P |v| plus half the type's
      subnormal spacing times the sum of |v| over the row's keys (the
      16-bit wgmma kernel feeds p to P V as two halves of the type, hi and
      lo: relative error u_in^2, or that absolute where lo is subnormal);
    * ds = p (dp - delta) (1 - t^2): p (e_p |dp - delta| + |d dp| +
      |d delta|) (1 + 4u), plus, under a softcap, p |dp - delta| (2 |ds| /
      cap + 6u) for 1 - t^2;
    * dv = sum over the G Sq rows of p dout: sum p |dout| (e_p +
      gamma(G Sq + 2)); dk = sum of ds (scale q): sum (|d ds| +
      gamma(G Sq + 2) |ds|) |scale q|; dq = scale sum over keys of ds k:
      scale sum (|d ds| + gamma(Skv + 2) |ds|) |k| (1 + u).

    With ``split`` one side (the gradient's tensor-core instance) feeds its
    float32 p and ds to the dv, dk and dq products as two halves of the
    16-bit input type, hi = E(x) and lo = E(x - hi). x - hi is exact in
    float32 (hi is x's nearest neighbour in E, which holds fewer bits), and
    |x - hi| <= u_in |x|, so |x - (hi + lo)| = |(x - hi) - E(x - hi)| <=
    u_in |x - hi| <= u_in^2 |x| where x - hi is in E's normal range, and at
    most half E's subnormal spacing where it is not (where x itself is
    below the normal range, hi and lo each land on the subnormal grid and
    the pair is off by that half spacing). So that side's e_p and ds's
    relative error gain u_in^2, plus that absolute on every term the mask
    keeps (a masked p is 0 and splits exactly), and each of its sums adds
    twice the terms (a hi and a lo product each): gamma(2 G Sq + 2) over
    rows, gamma(2 Skv + 2) over keys. The bound is then that side's plus the
    other side's, which stays float32 arithmetic. The tensor cores' float32
    sums are taken to round as a float32 add does.

    In a 16-bit type both sides round their float32 result once, which
    adds 2 u_in (|ref| + the float32 bound) and twice half the spacing of
    the type's subnormals; ``ref`` is the side held to the other (its
    rounded (dq, dk, dv)), required then. The bound is worst case: the
    sums' rounding errors are not taken to cancel.

    With ``split="tf32"`` one side (the gradient's float32 tensor-core
    instance) takes every product a b of a sum (s = q.k, dp = dout.v and
    the p dout, ds q and ds k terms of dv, dk and dq) as three TF32
    products of the operands' halves, big = tf32(x) and small = tf32(x -
    big), each rounded to nearest (TF32 keeps 10 fraction bits: unit u_t
    = 2^-11, half its subnormal spacing sig_t = 2^-137): x - big is exact
    in float32 and |x - big| <= u_t |x|, so x = big + small + e with |e|
    <= u_t^2 |x| + sig_t, and |small| <= u_t (1 + u_t) |x| + sig_t. The
    side computes big_a big_b + big_a small_b + small_a big_b = (a - e_a)
    (b - e_b) - small_a small_b, off a b by at most e3 |a| |b| + 2 sig_t
    (|a| + |b| + sig_t) with e3 = u_t^2 (3 + 2 u_t + 2 u_t^2) (e_a b, a e_b,
    e_a e_b and the dropped small product). Each product is exact in
    float32 (22 bits), and a sum of n terms adds 3n of them, whose
    magnitudes add to at most (1 + 5 u_t) sum |a| |b|: gamma(3n + 2) (1 +
    5 u_t) over |a|.|b|. (The instance takes s and dp as all four
    products, (big_a + small_a) (big_b + small_b), in two chains of 2D
    terms added once: off by 2 u_t^2 + u_t^4 < e3 a term, a sum tree of
    depth 2D + 1, the same magnitudes: inside the same bound.) So that
    side's s and dp take g3(D) = e3 + gamma(3 D + 2) (1 + 5 u_t) in place
    of gamma(D + 2) (its e_p and ds follow from them as above), and its
    sums of dv, dk and dq take
    g3(G Sq) and g3(Skv) in place of gamma(G Sq + 2) and gamma(Skv + 2),
    the absolute term on every kept term. delta stays float32 on both
    sides. The tensor cores' float32 sums are taken to round as a float32
    add does; the card test is what tests it. This is explicit arithmetic
    held to the float32 bound, not TF32 mode: a single pass (big big
    alone) is off by ~2^-11 a term and fails it."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    f64 = torch.float64
    qd = (q.to(f64) * scale).reshape(B, Sq, Hkv, G, D)
    kd, vd = k.to(f64), v.to(f64)
    dod = dout.to(f64).reshape(B, Sq, Hkv, G, D)
    od = out.to(f64).reshape(B, Sq, Hkv, G, D)
    lsed = lse.to(f64).reshape(B, Hkv, G, Sq)
    u_in = 0.0 if out.dtype == torch.float32 else (
        torch.finfo(out.dtype).eps / 2)
    sub = torch.finfo(out.dtype).smallest_normal * u_in   # half a subnormal
    tf32 = split == "tf32"
    if split not in (False, True, "tf32"):
        raise ValueError(f"backward_error_bound: split={split!r}")
    if split is True and not u_in:
        raise ValueError("backward_error_bound: split halves need a 16-bit "
                         "input type")
    u_t, sig_t = 2.0 ** -11, 2.0 ** -137       # TF32's unit, half subnormal
    e3 = u_t ** 2 * (3 + 2 * u_t + 2 * u_t ** 2)

    def g3(n):
        return e3 + gamma(3 * n + 2) * (1 + 5 * u_t)

    g_d = gamma(D + 2)
    # per side: (gamma over rows, gamma over keys, relative split error,
    # absolute split error per kept term, TF32 products); the first side is
    # float32
    sides = [(gamma(G * Sq + 2), gamma(Skv + 2), 0.0, 0.0, False)]
    if split is True:
        sides.append((gamma(2 * G * Sq + 2), gamma(2 * Skv + 2), u_in ** 2,
                      sub, False))
    elif tf32:
        sides.append((g3(G * Sq), g3(Skv), 0.0, 0.0, True))
    bq = torch.zeros((len(sides), B, Sq, Hkv, G, D), dtype=f64,
                     device=q.device)
    bk = torch.zeros((len(sides), B, Skv, Hkv, D), dtype=f64,
                     device=q.device)
    bv = torch.zeros_like(bk)
    for c0 in range(0, Sq, Q_CHUNK):
        c1 = min(Sq, c0 + Q_CHUNK)
        lo, hi = q_offset + c0, q_offset + c1
        k0, k1 = _chunk_keys(lo, hi, window)
        qc, doc, oc = qd[:, c0:c1], dod[:, c0:c1], od[:, c0:c1]
        kc, vc = kd[:, k0:k1], vd[:, k0:k1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc)
        qk_abs = torch.einsum("bqhgd,bkhd->bhgqk", qc.abs(), kc.abs())
        err_s = g_d * qk_abs
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        err_s += 4 * u * s.abs()
        if tf32:
            # the TF32 side's scores: the scale multiplies the sum once
            l1 = lambda x: x.abs().sum(-1)
            err_s_t = (g3(D) * qk_abs + 4 * u * s.abs() + 2 * sig_t * (
                l1(qc).permute(0, 2, 3, 1)[..., None]
                + scale * l1(kc).permute(0, 2, 1)[:, :, None, None]
                + D * sig_t * scale))
        del qk_abs
        i = torch.arange(lo, hi, device=q.device)[:, None]
        j = torch.arange(k0, k1, device=q.device)[None, :]
        mask = i >= j
        if window:
            mask &= (i - j) < window
        sm = torch.where(mask, s, -math.inf)
        m = sm.amax(-1, keepdim=True)
        l_ = torch.exp(sm - m).sum(-1, keepdim=True)
        lse_x = m + torch.log(l_)                       # the exact lse
        P = torch.exp(sm - lse_x)                        # 0 off the mask
        l_c = lsed[..., c0:c1, None]
        if same_stats:
            # both sides exponentiate against the given lse
            P = torch.exp(sm - l_c)
            e_stat = u * (s.abs() + l_c.abs()) + 2 * u
        else:
            e_lse = (2 * torch.where(mask, err_s, 0.0).amax(-1, keepdim=True)
                     + u * (torch.where(mask, s.abs(), 0.0)
                            .amax(-1, keepdim=True) + m.abs())
                     + gamma(Skv + 4) + u * (torch.log(l_).abs()
                                            + lse_x.abs()) + 2 * u)
            e_stat = e_lse + u * (s.abs() + lse_x.abs()) + 2 * u
        e_p = err_s + e_stat
        del sm
        dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
        dv_abs = torch.einsum("bqhgd,bkhd->bhgqk", doc.abs(), vc.abs())
        err_dp = g_d * dv_abs
        if tf32:
            err_dp_t = g3(D) * dv_abs + 2 * sig_t * (
                doc.abs().sum(-1).permute(0, 2, 3, 1)[..., None]
                + vc.abs().sum(-1).permute(0, 2, 1)[:, :, None, None]
                + D * sig_t)
        del dv_abs
        delta = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]
        err_delta = g_d * (doc.abs() * oc.abs()).sum(-1)
        if not same_stats:
            e_fwd = (torch.where(mask, e_p, 0.0).amax(-1) + sides[0][1]
                     + u_in ** 2)
            pv = torch.einsum("bhgqk,bkhd->bqhgd", P, vc.abs())
            err_o = (u_in * oc.abs()
                     + e_fwd.permute(0, 3, 1, 2)[..., None] * pv
                     + sub * torch.einsum("qk,bkhd->bqhd", mask.to(f64),
                                          vc.abs())[:, :, :, None])
            err_delta = err_delta + (doc.abs() * err_o).sum(-1)
            del pv, err_o
        err_delta = err_delta.permute(0, 2, 3, 1)[..., None]
        resid = (dp - delta).abs()
        ds_abs = P * resid
        if softcap:
            ds_abs = ds_abs * (1 - t * t).abs()

        def ds_error(e_s, e_dp):
            err = P * ((e_s + e_stat) * resid + e_dp + err_delta) * (1 + 4 * u)
            if softcap:
                err = err + P * resid * (2 * e_s / softcap + 6 * u)
            return err

        err_ds = ds_error(err_s, err_dp)
        mask64 = mask.to(f64)
        for i, (g_rows, g_keys, e_h, s_h, side_tf32) in enumerate(sides):
            s_h = s_h * mask64
            ep, eds = e_p, err_ds
            if side_tf32:
                ep = err_s_t + e_stat
                eds = ds_error(err_s_t, err_dp_t)
            bv[i, :, k0:k1] += torch.einsum(
                "bhgqk,bqhgd->bkhd", P * (ep + g_rows + e_h) + s_h,
                doc.abs())
            w = eds + (g_rows + e_h) * ds_abs + s_h
            bk[i, :, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", w,
                                            qc.abs())
            w = eds + (g_keys + e_h) * ds_abs + s_h
            bq[i, :, c0:c1] = scale * (1 + u) * torch.einsum(
                "bhgqk,bkhd->bqhgd", w, kc.abs())
            if side_tf32:
                # the splits' absolute term on every kept term: 2 sig_t
                # (|a| + |b| + sig_t) for the p dout, ds (scale q) and
                # scale ds k products
                a_p = mask64 * (P * (1 + ep) + sig_t)
                a_ds = mask64 * (ds_abs + eds + sig_t)
                ones = lambda x: torch.ones_like(x[..., :1])
                bv[i, :, k0:k1] += 2 * sig_t * (
                    torch.einsum("bhgqk,bqhgd->bkhd", a_p, ones(doc))
                    + torch.einsum("qk,bqhgd->bkhd", mask64, doc.abs()))
                bk[i, :, k0:k1] += 2 * sig_t * scale * (
                    torch.einsum("bhgqk,bqhgd->bkhd", a_ds, ones(qc))
                    + torch.einsum("qk,bqhgd->bkhd", mask64,
                                   qc.abs() / scale))
                bq[i, :, c0:c1] += 2 * sig_t * scale * (1 + u) * (
                    torch.einsum("bhgqk,bkhd->bqhgd", a_ds, ones(kc))
                    + torch.einsum("qk,bkhd->bqhd", mask64,
                                   kc.abs())[:, :, :, None])
        if softcap:
            del t
        del dp, err_dp, resid, P, e_p, err_s, err_ds, ds_abs, w
    # both sides: twice the float32 side's, or the float32 side's plus the
    # split side's
    bq, bk, bv = (x[0] + x[-1] for x in (bq, bk, bv))
    bounds = [bq.reshape(B, Sq, H, D), bk, bv]
    if u_in:
        if ref is None:
            raise ValueError("backward_error_bound: a 16-bit gradient needs "
                             "ref, the side it is held to")
        bounds = [b + 2 * u_in * (r.to(f64).abs() + b) + 2 * sub
                  for b, r in zip(bounds, ref)]
    return tuple(bounds)
