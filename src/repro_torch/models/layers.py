"""Core transformer layers as functions over param dicts — port of
``repro.models.layers``.

Numerics follow the reference step by step, so that float32 runs agree
within summation order and bfloat16 and float16 runs round at the same
places:
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
whose forward is the kernel with each row's logsumexp and whose backward is
the hand-written gradient kernel (on the CPU, their chunked plain
versions): like the reference's ``blockwise_attention``, whose gradient
JAX takes with each chunk's scores recomputed, it never holds an (S, S)
buffer. :func:`chunked_cross_entropy`
is the reference's loss over sequence chunks, each checkpointed, so the
(B, S, V) logits never exist.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.param import ParamDef

NEG_INF = -1e30
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name as a torch dtype: every model dtype the
    reference's ``jnp.dtype(cfg.dtype)`` takes."""
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
    and the flash-attention gradient kernel as its backward
    (``fa_ops.flash_attention`` and ``fa_ops.flash_attention_backward``:
    the kernels on a CUDA tensor, the chunked plain versions on a CPU one).
    Where an input needs a gradient, the forward also asks the kernel for
    each row's logsumexp and saves (q, k, v, out, lse); the backward
    recomputes the scores tile by tile from them at the same ``q_offset``,
    so no (Sq, Skv) tensor is held. ``scale`` is 1.0 here: callers scale q
    first. Where no input needs a gradient (serving: frozen weights, or
    ``torch.no_grad``) ``apply`` is the forward alone, with no logsumexp:
    serving keeps its bits and its launch counts."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float,
                q_offset: int = 0):
        kw = dict(window=window, softcap=softcap, scale=1.0,
                  q_offset=q_offset)
        if not any(ctx.needs_input_grad[:3]):
            return fa_ops.flash_attention(q, k, v, **kw)
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = fa_ops.flash_attention(q, k, v, lse=lse, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa_ops.flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, **ctx.kw)
        return dq, dk, dv, None, None, None


def blockwise_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                        scale=None, q_offset: int = 0):
    """Causal (optionally sliding-window) attention of a prefill: keys at
    positions 0..Skv-1, every key valid; queries at ``q_offset`` ..
    ``q_offset + Sq - 1`` (offset 0 and Sq = Skv: every position, the
    unsharded prefill; a context-parallel shard passes its own rows).

    q: (B, Sq, Hkv, G, Dh); k, v: (B, Skv, Hkv, Dh). Returns
    (B, Sq, Hkv, G, Dh). The reference's jnp online-softmax recurrence and
    its Pallas kernel compute the same thing; here it is one
    flash-attention launch.
    """
    B, S, Hkv, G, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    q = scale_by(q, scale).reshape(B, S, Hkv * G, Dh)
    out = FlashAttentionFn.apply(q, k.contiguous(), v.contiguous(),
                                 int(window), float(softcap), int(q_offset))
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


def decode_attention_partial(q, k, v, *, kv_positions, kv_valid,
                             q_position, window: int = 0,
                             softcap: float = 0.0, scale=None):
    """:func:`decode_attention` over one shard's block of cache slots,
    unnormalised: returns (o, mx, l), o the float32 sum of exp(s - mx)
    times v over the block's valid slots, mx the block's largest score
    (``NEG_INF`` where it holds none) and l the sum of the weights, each
    (B, 1, Hkv, G, ...). :func:`combine_partials` merges the shards'."""
    Dh = q.shape[-1]
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    s = torch.einsum("bqhgd,bkhd->bqhgk", scale_by(q, scale).float(),
                     k.float())
    s = _softcap(s, softcap)
    mask = kv_valid & (kv_positions <= q_position[:, None])
    if window and window > 0:
        mask &= (q_position[:, None] - kv_positions) < window
    mask = mask[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    mx = s.max(dim=-1, keepdim=True).values
    p = torch.where(mask, torch.exp(s - mx), 0.0)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o, mx, p.sum(dim=-1, keepdim=True)


def combine_partials(mxs, os, ls):
    """One shard's merge of every shard's :func:`decode_attention_partial`
    (each list in the shards' order): the softmax over all their slots,
    float32."""
    M = torch.stack(mxs).max(dim=0).values
    num = den = None
    for o, mx, l in zip(os, mxs, ls):
        w = torch.exp(mx - M)
        num = o * w if num is None else num + o * w
        den = l * w if den is None else den + l * w
    return num / den


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
    """Project + rope. Returns q (B,S,H,Dh), k, v (B,S,Hkv,Dh); H and Hkv
    are the heads the projections hold (a shard's block of them on a
    mesh, all of them otherwise)."""
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    return (heads_of(q, p.get("q_norm"), cfg, positions),
            heads_of(k, p.get("k_norm"), cfg, positions),
            v.reshape(v.shape[:2] + (-1, cfg.resolved_head_dim)))


def heads_of(x, norm_w, cfg, positions):
    """A projected q or k, (B, S, n * Dh) -> (B, S, n, Dh): split into its
    heads, rms-normed per head (``qk_norm``, weight ``norm_w``) and roped
    at ``positions`` (B, S). Every op is per head and per row, so a head
    gathered from column blocks gives the bits of one projected whole."""
    B, S = x.shape[:2]
    x = x.reshape(B, S, -1, cfg.resolved_head_dim)
    if cfg.qk_norm:
        x = rms_norm(x, norm_w, cfg.norm_eps)
    return rope(x, positions, cfg.rope_theta)


def attention_out(p, attn, x_dtype):
    """attn: (B, S, Hkv, G, Dh), or any (B, S, ...) whose flat rows are
    the columns ``wo``'s rows hold -> (B, S, d)."""
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


def head_weight(p):
    """The (d, V) output projection: ``head``, or the tied table's
    transpose."""
    return p["head"] if "head" in p else p["table"].T


def head_logits(w, x, cfg):
    """float32 logits of ``x`` against the (d, V') weight ``w``,
    softcapped."""
    logits = x @ w.to(x.dtype)
    return _softcap(logits.float(), cfg.final_logit_softcap)


def lm_head(p, x, cfg):
    return head_logits(head_weight(p), x, cfg)


def chunked_cross_entropy(p, x, targets, cfg, chunk: int = 256, mask=None):
    """Mean next-token cross entropy over (B, S) positions, without a
    (B, S, V) buffer: per sequence chunk, the float32 logits (softcapped
    as ``lm_head``'s), their logsumexp minus the target's logit, masked
    and summed; the total over ``max(count, 1)``. Each chunk runs under
    ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward and only (B, chunk) values stay. The reference pads S to a
    multiple of ``chunk`` with masked positions; here the last chunk is
    short, which sums the same terms."""
    tot, cnt = ce_sums(head_weight(p), x, targets, cfg, chunk, mask)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_chunk(xc, tc, mc, w, cap):
    logits = (xc @ w.to(xc.dtype)).float()
    if cap:
        logits = _softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
    return ((lse - picked) * mc.float()).sum()


def ce_sums(w, x, targets, cfg, chunk: int = 256, mask=None):
    """The sum of :func:`chunked_cross_entropy`'s masked terms against the
    (d, V) weight ``w``, and the count of masked-in positions (float32
    scalars)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        tot = tot + checkpoint(_ce_chunk, x[:, sl], targets[:, sl],
                               mask[:, sl], w, cfg.final_logit_softcap,
                               use_reentrant=False)
    return tot, mask.float().sum()


def ce_chunk_local(xc, tc, w, offset: int, cap):
    """One vocab shard's part of a chunk's cross entropy: against the
    shard's columns ``w`` (d, V/m) of the vocab from ``offset``, the
    logsumexp of its logits and the target's logit where the target is
    its own (0 elsewhere), each (B, chunk)."""
    logits = (xc @ w.to(xc.dtype)).float()
    if cap:
        logits = _softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    V = w.shape[1]
    lt = tc.long() - offset
    mine = (lt >= 0) & (lt < V)
    picked = torch.gather(logits, -1, lt.clamp(0, V - 1)[..., None])[..., 0]
    return lse, torch.where(mine, picked, 0.0)
