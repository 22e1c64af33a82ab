"""RG-LRU recurrent block (RecurrentGemma / Griffin) — port of
``repro.models.rglru``.

Block structure (Griffin recurrent block):
    x -> norm -> [branch A: linear -> temporal conv(4) -> RG-LRU]
              -> [branch B: linear -> GeLU]  -> A * B -> out linear

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)          (data-dependent decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence over the whole sequence through
``kernels/rglru_scan`` (one launch a layer on the card, its plain
sequential version on the CPU), where the reference runs
``jax.lax.associative_scan``: the two agree within float32 rounding, not
bit for bit. Decode is the reference's single elementwise update in
plain torch. As in the reference, prefill's temporal conv sums its taps
one at a time in the activation dtype while decode contracts them with an
einsum, and GeLU is the tanh form (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.models.layers import dtype_of, rms_norm_defs
from repro_torch.models.param import ParamDef

_C = 8.0  # Griffin's fixed decay temperature


def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = dtype_of(cfg.param_dtype)
    s = 0.02
    lw = ("lru_width",)
    return {
        "norm": rms_norm_defs(d, dt),
        "w_x": ParamDef((d, w), ("d_model", "lru_width"), dt, "normal", s),
        "w_gate_branch": ParamDef((d, w), ("d_model", "lru_width"), dt,
                                  "normal", s),
        "conv_w": ParamDef((cfg.conv_width, w), ("conv", "lru_width"), dt,
                           "normal", s),
        "conv_b": ParamDef((w,), lw, dt, "zeros"),
        # RG-LRU gates (block-diagonal in Griffin; dense-per-channel here)
        "w_a": ParamDef((w,), lw, dt, "normal", s),
        "b_a": ParamDef((w,), lw, dt, "zeros"),
        "w_i": ParamDef((w,), lw, dt, "normal", s),
        "b_i": ParamDef((w,), lw, dt, "zeros"),
        "lam": ParamDef((w,), lw, dt, "uniform", low=0.9, high=0.999),
        "w_out": ParamDef((w, d), ("lru_width", "d_model"), dt, "normal",
                          s / math.sqrt(2 * cfg.n_layers)),
    }


def _gelu(x, dtype):
    """``jax.nn.gelu`` (tanh form) in float32, cast to ``dtype``."""
    return F.gelu(x.float(), approximate="tanh").to(dtype)


def _gates(p, u):
    """u: (..., w) conv output. Returns decay a and gated input (f32)."""
    uf = u.float()
    r = torch.sigmoid(uf * p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf * p["w_i"].float() + p["b_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, gated


def _conv_full(p, x, conv_state=None):
    """Causal depthwise temporal conv, width W. x: (B, S, w). The taps are
    summed one at a time from 0, in x's dtype, as the reference's
    Python ``sum``."""
    W = p["conv_w"].shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, w)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * p["conv_w"][i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return out + p["conv_b"].to(x.dtype), new_state


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: (B, S, w) float32; h0:
    (B, w) or None (zeros). Returns (all h_t, h_S): the kernel's wrapper
    (a CPU tensor takes its plain sequential loop)."""
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    return rglru_ops.rglru_scan(a.contiguous(), b.contiguous(),
                                h0.float().contiguous())


def rglru_apply(p, x, cfg, conv_state=None, h_state=None, *,
                return_state=False):
    """Full-sequence (prefill) Griffin recurrent block.

    x: (B, S, d) normalized input. Returns (out (B, S, d), (conv_state, h)
    or None)."""
    xb = x @ p["w_x"].to(x.dtype)
    gate = x @ p["w_gate_branch"].to(x.dtype)
    u, new_conv = _conv_full(p, xb, conv_state)
    a, b = _gates(p, u)
    hs, h_last = rglru_scan(a, b, h_state)                 # (B, S, w) f32
    h_out = hs.to(x.dtype) * _gelu(gate, x.dtype)
    out = h_out @ p["w_out"].to(x.dtype)
    if return_state:
        return out, (new_conv, h_last)
    return out, None


def rglru_step(p, x, cfg, conv_state, h_state):
    """Single-token decode step. x: (B, 1, d). States: (B, W-1, w),
    (B, w)."""
    xb = x @ p["w_x"].to(x.dtype)
    gate = x @ p["w_gate_branch"].to(x.dtype)
    hist = torch.cat([conv_state.to(x.dtype), xb], dim=1)   # (B, W, w)
    u = torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(x.dtype))[:, None]
    u = u + p["conv_b"].to(x.dtype)
    a, b = _gates(p, u)
    h = a[:, 0] * h_state.float() + b[:, 0]                 # (B, w)
    h_out = h[:, None, :].to(x.dtype) * _gelu(gate, x.dtype)
    out = h_out @ p["w_out"].to(x.dtype)
    return out, (hist[:, 1:].to(conv_state.dtype), h)
