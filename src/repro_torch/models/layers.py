"""Core transformer layers as functions over param dicts — port of
``repro.models.layers``.

Numerics follow the reference step by step, so that float32 runs agree
within summation order and bfloat16 runs round at the same places:
  * ``rms_norm`` and ``rope`` compute in float32 and cast back;
  * ``blockwise_attention`` multiplies q by the scale in the activation
    dtype, then runs the flash-attention op with ``scale=1.0`` (the
    hand-written kernel on the card, its plain version on the CPU);
  * ``embed_tokens`` scales a tied table by sqrt(d) in the activation
    dtype; ``lm_head`` takes its product in the activation dtype and only
    then casts to float32.
RoPE uses interleaved (even, odd) pairs. GQA never repeats KV heads: q is
laid out (kv_head, q_per_kv) along its flat head axis, so q head
h = kv * G + g reads kv head h // G.

Training: ``blockwise_attention`` goes through :class:`FlashAttentionFn`,
whose forward is the kernel (the plain version on the CPU) and whose
backward recomputes the plain version under autograd: no backward kernel
exists in either package (the reference trains through jnp attention and
its Pallas kernel has no ``custom_vjp``). :func:`chunked_cross_entropy`
is the reference's loss over sequence chunks, each checkpointed, so the
(B, S, V) logits never exist.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.param import ParamDef

NEG_INF = -1e30
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DT[name]


def scale_by(x, c: float):
    """``x * c`` with ``c`` first rounded to x's dtype, as JAX rounds a
    weakly typed Python scalar (in bfloat16, 1/sqrt(128) becomes
    0.08837890625)."""
    return x * torch.tensor(c, dtype=x.dtype).item()


# ---------------------------------------------------------------- norms
def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dt)


def rms_norm_defs(d: int, dt) -> ParamDef:
    # gemma-style (1 + w) scaling; zero-init == identity
    return ParamDef((d,), ("d_model",), dt, "zeros")


# ------------------------------------------------------------------ rope
def rope(x, positions, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) integer positions."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(angles)[..., None, :]                  # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x_f = x.float().reshape(x.shape[:-1] + (half, 2))
    even, odd = x_f[..., 0], x_f[..., 1]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], -1)
    return out.reshape(x.shape).to(x.dtype)


# -------------------------------------------------------------- attention
def _softcap(scores, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


class FlashAttentionFn(torch.autograd.Function):
    """Causal GQA attention with the flash-attention kernel as its forward
    (``fa_ops.flash_attention``: the kernel on a CUDA tensor, the plain
    version on a CPU one) and, as its backward, autograd through the plain
    version (``attention_ref``) recomputed from the saved (q, k, v). The
    recompute holds the (B, H, S, S) float32 scores of one layer for the
    length of its backward. ``scale`` is 1.0 here: callers scale q first.
    Under ``torch.no_grad`` (serving) ``apply`` is the forward alone, so
    serving keeps its bits and its launch counts."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.softcap = window, softcap
        return fa_ops.flash_attention(q, k, v, window=window,
                                      softcap=softcap, scale=1.0)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*qkv, window=ctx.window,
                                softcap=ctx.softcap, scale=1.0)
            dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None, None


def blockwise_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                        scale=None):
    """Causal (optionally sliding-window) attention of a prefill: queries
    and keys at positions 0..S-1, every key valid.

    q: (B, S, Hkv, G, Dh); k, v: (B, S, Hkv, Dh). Returns (B, S, Hkv, G, Dh).
    The reference's jnp online-softmax recurrence and its Pallas kernel
    compute the same thing; here it is one flash-attention launch.
    """
    B, S, Hkv, G, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    q = scale_by(q, scale).reshape(B, S, Hkv * G, Dh)
    out = FlashAttentionFn.apply(q, k.contiguous(), v.contiguous(),
                                 int(window), float(softcap))
    return out.reshape(B, S, Hkv, G, Dh)


def decode_attention(q, k, v, *, kv_positions, kv_valid, q_position,
                     window: int = 0, softcap: float = 0.0, scale=None):
    """Single-position attention against a (possibly ring) KV cache.

    q: (B, 1, Hkv, G, Dh); k, v: (B, Skv, Hkv, Dh); kv_positions/kv_valid:
    (B, Skv); q_position: (B,) absolute position. Products accumulate in
    float32 (the reference's ``preferred_element_type``); p is rounded to
    v's dtype before the PV product, as there.
    """
    Dh = q.shape[-1]
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    s = torch.einsum("bqhgd,bkhd->bqhgk", scale_by(q, scale).float(),
                     k.float())
    s = _softcap(s, softcap)
    mask = kv_valid & (kv_positions <= q_position[:, None])
    if window and window > 0:
        mask &= (q_position[:, None] - kv_positions) < window
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_defs(cfg) -> dict:
    """Attention projections with flattened head dims; the q flat layout is
    (kv_group, q_per_kv, head_dim) row-major."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    dt = dtype_of(cfg.param_dtype)
    s = 0.02
    defs = {
        "norm": rms_norm_defs(d, dt),
        "wq": ParamDef((d, H * Dh), ("d_model", "heads_flat"), dt, "normal",
                       s),
        "wk": ParamDef((d, Hkv * Dh), ("d_model", "kv_flat"), dt, "normal",
                       s),
        "wv": ParamDef((d, Hkv * Dh), ("d_model", "kv_flat"), dt, "normal",
                       s),
        "wo": ParamDef((H * Dh, d), ("heads_flat", "d_model"), dt, "normal",
                       s / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((Dh,), ("head_dim",), dt, "zeros")
        defs["k_norm"] = ParamDef((Dh,), ("head_dim",), dt, "zeros")
    if cfg.post_norms:
        defs["post_norm"] = rms_norm_defs(d, dt)
    return defs


def attention_qkv(p, x, cfg, positions):
    """Project + rope. Returns q (B,S,H,Dh), k, v (B,S,Hkv,Dh)."""
    B, S = x.shape[:2]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attention_out(p, attn, x_dtype):
    """attn: (B, S, Hkv, G, Dh) -> (B, S, d)."""
    B, S = attn.shape[:2]
    return attn.reshape(B, S, -1) @ p["wo"].to(x_dtype)


# ------------------------------------------------------------------ MLP
def mlp_defs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    defs = {
        "norm": rms_norm_defs(d, dt),
        "w_gate": ParamDef((d, f), ("d_model", "d_ff"), dt, "normal", 0.02),
        "w_up": ParamDef((d, f), ("d_model", "d_ff"), dt, "normal", 0.02),
        "w_down": ParamDef((f, d), ("d_ff", "d_model"), dt, "normal",
                           0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.post_norms:
        defs["post_norm"] = rms_norm_defs(d, dt)
    return defs


def mlp_apply(p, x):
    """SwiGLU: silu in float32, cast back, times the up projection."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"].to(x.dtype)


# ------------------------------------------------------ embedding / head
def embed_defs(cfg) -> dict:
    dt = dtype_of(cfg.param_dtype)
    defs = {
        # ~N(0, 1/d): tied heads get O(1) logits; the sqrt(d) input scaling
        # for tied models restores unit-variance embeddings
        "table": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "d_model"),
                          dt, "normal", 1.0 / math.sqrt(cfg.d_model)),
        "final_norm": rms_norm_defs(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                ("d_model", "vocab"), dt, "normal", 0.02)
    return defs


def embed_tokens(p, tokens, cfg):
    x = p["table"][tokens.long()].to(dtype_of(cfg.dtype))
    if cfg.tie_embeddings:
        # gemma-style scaled tied embedding
        x = scale_by(x, math.sqrt(cfg.d_model))
    return x


def lm_head(p, x, cfg):
    w = p["head"] if "head" in p else p["table"].T
    logits = x @ w.to(x.dtype)
    return _softcap(logits.float(), cfg.final_logit_softcap)


def chunked_cross_entropy(p, x, targets, cfg, chunk: int = 256, mask=None):
    """Mean next-token cross entropy over (B, S) positions, without a
    (B, S, V) buffer: per sequence chunk, the float32 logits (softcapped
    as ``lm_head``'s), their logsumexp minus the target's logit, masked
    and summed; the total over ``max(count, 1)``. Each chunk runs under
    ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward and only (B, chunk) values stay. The reference pads S to a
    multiple of ``chunk`` with masked positions; here the last chunk is
    short, which sums the same terms."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    w = p["head"] if "head" in p else p["table"].T

    def step(xc, tc, mc, w):
        logits = (xc @ w.to(xc.dtype)).float()
        if cfg.final_logit_softcap:
            logits = _softcap(logits, cfg.final_logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
        return ((lse - picked) * mc.float()).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        tot = tot + checkpoint(step, x[:, sl], targets[:, sl], mask[:, sl],
                               w, use_reentrant=False)
    cnt = mask.float().sum()
    return tot / torch.clamp(cnt, min=1.0)
