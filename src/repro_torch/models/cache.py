"""Decode-time state: KV caches (global + local ring) and the RG-LRU and
RWKV recurrent states — port of ``repro.models.cache``. Every leaf leads
with the batch, so a serving engine selects each per slot.

Slot/position conventions (L = tokens written so far, per sample):
  * global cache: slot j holds absolute position j; valid iff j < L.
  * ring cache (W slots): slot j holds the largest position p < L with
    p = j (mod W); valid iff 0 <= p (once anything was written there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of
from repro_torch.models.param import ParamDef


def kv_cache_defs(cfg, batch: int, max_seq: int, *, window: int = 0) -> dict:
    size = min(window, max_seq) if window else max_seq
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    dims = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": ParamDef((batch, size, hkv, dh), dims, dt, "zeros"),
        "v": ParamDef((batch, size, hkv, dh), dims, dt, "zeros"),
    }


def rglru_cache_defs(cfg, batch: int) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, w),
                         ("batch", "conv", "lru_width"), dtype_of(cfg.dtype),
                         "zeros"),
        "h": ParamDef((batch, w), ("batch", "lru_width"), torch.float32,
                      "zeros"),
    }


def rwkv_cache_defs(cfg, batch: int) -> dict:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    dt = dtype_of(cfg.dtype)
    return {
        "shift": ParamDef((batch, d), ("batch", "d_model"), dt, "zeros"),
        "wkv": ParamDef((batch, d // hd, hd, hd),
                        ("batch", "rwkv_heads", "head_dim", "head_dim2"),
                        torch.float32, "zeros"),
        "cm_shift": ParamDef((batch, d), ("batch", "d_model"), dt, "zeros"),
    }


def slot_positions(lengths, cache_size: int, window: int = 0):
    """Absolute positions + validity per cache slot. lengths: (B,) tokens
    written so far (a decode step passes L + 1, counting its own write)."""
    j = torch.arange(cache_size, device=lengths.device)[None, :]
    L = lengths[:, None].to(torch.int64)
    if window:
        # ring buffers are allocated at exactly min(window, max_seq)
        pos = (L - 1) - torch.remainder(L - 1 - j, cache_size)
        valid = (pos >= 0) & (L > 0)
    else:
        pos = j.expand(lengths.shape[0], cache_size)
        valid = j < L
    return pos, valid


def write_token(buf, new, lengths, window: int = 0):
    """Write one token's k/v into a copy of the cache. buf: (B, S, H, D);
    new: (B, 1, H, D); lengths: (B,) tokens already present (the write
    position). The copy keeps the reference's value semantics: a serving
    engine merges old and new caches per slot, and a ring slot written in
    place would clobber a live key of a slot that does not advance."""
    size = buf.shape[1]
    L = lengths.to(torch.int64)
    idx = torch.remainder(L, size) if window else L.clamp(0, size - 1)
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), idx] = \
        new[:, 0].to(buf.dtype)
    return out


def fill_from_prefill(kv, cache_size: int, window: int = 0):
    """Build a cache buffer from prefill-computed k or v: (B, S, H, D)."""
    S = kv.shape[1]
    if window:
        w = cache_size
        if S >= w:
            return torch.roll(kv[:, S - w:], shifts=S % w, dims=1)
        return F.pad(kv, (0, 0, 0, 0, 0, w - S))
    if S >= cache_size:
        return kv[:, :cache_size].contiguous()
    return F.pad(kv, (0, 0, 0, 0, 0, cache_size - S))
