"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix —
port of ``repro.models.rwkv6``.

Recurrence (per head, head_dim = hd):
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T       S: (hd_k, hd_v), w_t in (0,1)
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with data-dependent per-channel decay  w_t = exp(-exp(wb + tanh(x W_A) W_B))
and a learned per-head "bonus" u for the current token.

Two execution paths, as in the reference (``LM(rwkv_chunk=...)`` picks):
  * ``_scan_wkv``    — the exact sequential recurrence, a Python loop over
    time (decode is its single-step specialization);
  * ``_chunked_wkv`` — chunkwise-parallel: within a chunk of L tokens an
    explicit (L, L, hd) decay tensor ``exp(lp[t-1] - lp[s]) <= 1``, chunks
    stitched with the carried state; every exp is of a non-positive
    number.
``_group_norm`` takes the population variance (``jnp.var``), not
``torch.var``'s default Bessel-corrected one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, rms_norm_defs
from repro_torch.models.param import ParamDef

_LORA = 64  # decay LoRA rank


def rwkv_defs(cfg) -> dict:
    d = cfg.d_model
    f = cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    s = 0.02
    so = s / math.sqrt(2 * cfg.n_layers)
    hf = ("heads_flat",)
    return {
        "norm": rms_norm_defs(d, dt),
        # token-shift mix coefficients for r,k,v,g,w
        "mu": ParamDef((5, d), ("mix5", "d_model"), dt, "uniform"),
        "w_r": ParamDef((d, d), ("d_model", "heads_flat"), dt, "normal", s),
        "w_k": ParamDef((d, d), ("d_model", "heads_flat"), dt, "normal", s),
        "w_v": ParamDef((d, d), ("d_model", "heads_flat"), dt, "normal", s),
        "w_g": ParamDef((d, d), ("d_model", "heads_flat"), dt, "normal", s),
        "w_o": ParamDef((d, d), ("heads_flat", "d_model"), dt, "normal", so),
        # data-dependent decay: w = exp(-exp(wb + tanh(x A) B))
        "decay_base": ParamDef((d,), hf, dt, "uniform", low=-1.0, high=1.0),
        "decay_A": ParamDef((d, _LORA), ("d_model", "lora"), dt, "normal", s),
        "decay_B": ParamDef((_LORA, d), ("lora", "heads_flat"), dt, "normal",
                            s),
        "bonus_u": ParamDef((d,), hf, dt, "normal", s),
        "ln_out": ParamDef((d,), hf, dt, "zeros"),  # per-head groupnorm scale
        # channel mix
        "cm_norm": rms_norm_defs(d, dt),
        "cm_mu": ParamDef((2, d), ("mix2", "d_model"), dt, "uniform"),
        "cm_k": ParamDef((d, f), ("d_model", "d_ff"), dt, "normal", s),
        "cm_v": ParamDef((f, d), ("d_ff", "d_model"), dt, "normal", so),
        "cm_r": ParamDef((d, d), ("d_model", "heads_flat"), dt, "normal", s),
    }


def _token_shift(x, x_prev_last):
    """shifted[t] = x[t-1]; shifted[0] = carried last token of prev
    segment."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1]], dim=1)


def _rkvgw(p, x, shifted, cfg):
    """Project the five mixed streams. x, shifted: (B, S, d)."""
    mu = p["mu"].to(x.dtype)  # (5, d)
    xr, xk, xv, xg, xw = (x + (shifted - x) * mu[i] for i in range(5))
    r = xr @ p["w_r"].to(x.dtype)
    k = xk @ p["w_k"].to(x.dtype)
    v = xv @ p["w_v"].to(x.dtype)
    g = xg @ p["w_g"].to(x.dtype)
    lora = torch.tanh(xw.float() @ p["decay_A"].float())
    log_w = -torch.exp(torch.clamp(
        p["decay_base"].float() + lora @ p["decay_B"].float(), -8.0, 3.0))
    # clamp decay so chunked exp() differences stay in f32 range
    log_w = torch.clamp(log_w, -20.0, -1e-5)
    return r, k, v, g, log_w


def _heads(x, hd):
    B, S, d = x.shape
    return x.reshape(B, S, d // hd, hd)


def _group_norm(x, scale, eps):
    """Per-head LayerNorm of the wkv output. x: (B, S, H, hd). The
    variance is the population one (``jnp.var``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    n = (xf - mean) * torch.rsqrt(var + eps)
    return n.reshape(x.shape[:2] + (-1,)) * (1.0 + scale.float())


def _out(p, wkv, g, x, cfg):
    """Group norm, the silu gate and the output projection."""
    out = _group_norm(wkv.to(x.dtype), p["ln_out"], cfg.norm_eps)
    out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    return out @ p["w_o"].to(x.dtype)


def time_mix(p, x, cfg, state=None, *, chunk: int = 0,
             return_state: bool = False):
    """RWKV-6 time-mix over a full sequence.

    x: (B, S, d). state: dict(shift (B, d), wkv (B, H, hd, hd) f32) or
    None."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    shift0 = state["shift"].to(x.dtype) if state else x.new_zeros((B, d))
    S0 = state["wkv"] if state else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=x.device)
    shifted = _token_shift(x, shift0)
    r, k, v, g, log_w = _rkvgw(p, x, shifted, cfg)
    rh, kh, vh = (_heads(t, hd).float() for t in (r, k, v))
    wh = _heads(log_w, hd)                                # (B, S, H, hd)
    u = p["bonus_u"].float().reshape(H, hd)

    if chunk and chunk > 1:
        wkv, S_new = _chunked_wkv(rh, kh, vh, wh, u, S0, chunk)
    else:
        wkv, S_new = _scan_wkv(rh, kh, vh, wh, u, S0)

    out = _out(p, wkv, g, x, cfg)
    if return_state:
        return out, {"shift": x[:, -1], "wkv": S_new}
    return out, None


def _wkv_step(S, rt, kt, vt, wt, u):
    """One step of the recurrence. S: (B, H, hd, hd); rt, kt, vt, wt:
    (B, H, hd). Returns (out (B, H, hd), the next S)."""
    kv = kt[..., None] * vt[..., None, :]
    att = S + u[None, :, :, None] * kv
    out = torch.einsum("bhk,bhkv->bhv", rt, att)
    return out, torch.exp(wt)[..., None] * S + kv


def _scan_wkv(r, k, v, w_log, u, S0):
    """Exact sequential recurrence. r/k/v/w_log: (B, S, H, hd)."""
    B, Sq = r.shape[:2]
    S = S0
    outs = []
    for t in range(Sq):
        out, S = _wkv_step(S, r[:, t], k[:, t], v[:, t], w_log[:, t], u)
        outs.append(out)
    return torch.stack(outs, dim=1).reshape(B, Sq, -1), S


def _chunked_wkv(r, k, v, w_log, u, S0, L):
    """Chunkwise-parallel recurrence, overflow-safe.

    Within a chunk: decay(t, s) = exp(lp[t-1] - lp[s]) for s < t (<= 1),
    the diagonal uses the bonus u. Cross-chunk: carried state decayed by
    exp(lp[t-1]) (<= 1). All exps are of non-positive numbers.
    """
    B, S, H, hd = r.shape
    n = -(-S // L)
    pad = n * L - S
    if pad:
        zr = lambda t: F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v = zr(r), zr(k), zr(v)
        w_log = F.pad(w_log, (0, 0, 0, 0, 0, pad), value=-1e-5)
    strict = torch.arange(L, device=r.device)[:, None] > \
        torch.arange(L, device=r.device)[None, :]
    strict = strict[None, :, :, None, None]
    S_in = S0
    outs = []
    for c in range(n):
        sl = slice(c * L, (c + 1) * L)
        rr, kk, vv, ww = r[:, sl], k[:, sl], v[:, sl], w_log[:, sl]
        lp = torch.cumsum(ww, dim=1)                      # inclusive
        lp_prev = lp - ww                                 # exclusive
        # inter-chunk: r_t decayed-dot carried state
        inter = torch.einsum("blhk,bhkv->blhv", rr * torch.exp(lp_prev),
                             S_in)
        # intra-chunk: explicit (L, L, hd) decay tensor, all exps <= 0
        ddec = lp_prev[:, :, None] - lp[:, None, :]       # (B, Lt, Ls, H, hd)
        ddec = torch.where(strict, ddec, -torch.inf)
        amat = torch.einsum("blhk,bshk,blshk->blsh", rr, kk, torch.exp(ddec))
        diag = torch.einsum("blhk,hk,blhk->blh", rr, u, kk)
        intra = torch.einsum("blsh,bshv->blhv", amat, vv)
        intra = intra + diag[..., None] * vv
        # state to end of chunk
        k_dec = kk * torch.exp(lp[:, -1:] - lp)           # exps <= 0
        S_in = torch.exp(lp[:, -1])[..., None] * S_in \
            + torch.einsum("blhk,blhv->bhkv", k_dec, vv)
        outs.append(inter + intra)
    out = torch.cat(outs, dim=1)[:, :S]
    return out.reshape(B, S, -1), S_in


def time_mix_step(p, x, cfg, state):
    """Single-token decode. x: (B, 1, d)."""
    B, _, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    shifted = state["shift"].to(x.dtype)[:, None, :]
    r, k, v, g, log_w = _rkvgw(p, x, shifted, cfg)
    rh, kh, vh = (_heads(t, hd).float()[:, 0] for t in (r, k, v))
    wh = _heads(log_w, hd)[:, 0]                          # (B, H, hd)
    u = p["bonus_u"].float().reshape(H, hd)
    wkv, S_new = _wkv_step(state["wkv"], rh, kh, vh, wh, u)
    out = _out(p, wkv.reshape(B, 1, d), g, x, cfg)
    return out, {"shift": x[:, -1], "wkv": S_new}


def channel_mix(p, x, cfg, state=None, *, return_state: bool = False):
    """RWKV channel-mix (the FFN analogue). x: (B, S, d) normalized."""
    B, S, d = x.shape
    shift0 = state.to(x.dtype) if state is not None else x.new_zeros((B, d))
    shifted = _token_shift(x, shift0)
    mu = p["cm_mu"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    kk = torch.square(torch.relu(xk @ p["cm_k"].to(x.dtype)))
    out = torch.sigmoid((xr @ p["cm_r"].to(x.dtype)).float()).to(x.dtype) \
        * (kk @ p["cm_v"].to(x.dtype))
    if return_state:
        return out, x[:, -1]
    return out, None
