"""Plain PyTorch version of the flash-attention kernel (twin of
``repro.kernels.flash_attention.ref.attention_ref``).

It materializes the full (Sq, Skv) score matrix and repeats the kernel's
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
                  scale=None, q_offset: int = 0):
    """Causal GQA attention, model layout: q (B, Sq, H, D); k, v
    (B, Skv, Hkv, D) with H % Hkv == 0, q head h reading kv head h // G.
    Query row i sits at position ``q_offset + i``, keys at 0..Skv-1
    (``q_offset + Sq <= Skv``; Sq = Skv at offset 0 is the whole causal
    pass). Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
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
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
