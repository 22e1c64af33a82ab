"""Plain PyTorch version of the flash-attention kernel (twin of
``repro.kernels.flash_attention.ref.attention_ref``).

It materializes the full (S, S) score matrix and repeats the kernel's
arithmetic: inputs upcast to float32, q scaled in float32 before the
product, the tanh softcap before the mask, masked scores at ``NEG_INF``,
the row max floored at ``MAX_FLOOR`` and the denominator at ``DENOM_FLOOR``
(the constants of ``src/repro/kernels/flash_attention/kernel.py``), p kept
in float32 for the PV product, and the result cast to q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
MAX_FLOOR = -1e29
DENOM_FLOOR = 1e-30


def attention_ref(q, k, v, *, window: int = 0, softcap: float = 0.0,
                  scale=None):
    """Causal GQA attention, model layout: q (B, S, H, D); k, v
    (B, S, Hkv, D) with H % Hkv == 0, q head h reading kv head h // G.
    Queries and keys sit at positions 0..S-1. Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = (q.float() * scale).reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = i >= j
    if window:
        mask &= (i - j) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True).clamp(min=MAX_FLOOR)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True).clamp(min=DENOM_FLOOR)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)
