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


def write_index(lengths, size: int, window: int = 0):
    """The slot a decode step writes for each sample: ``lengths`` mod the
    ring's size, or clamped into a global cache."""
    L = lengths.to(torch.int64)
    return torch.remainder(L, size) if window else L.clamp(0, size - 1)


def write_token(buf, new, lengths, window: int = 0, shard=None):
    """Write one token's k/v into a copy of the cache. buf: (B, S, H, D);
    new: (B, 1, H, D); lengths: (B,) tokens already present (the write
    position). The copy keeps the reference's value semantics: a serving
    engine merges old and new caches per slot, and a ring slot written in
    place would clobber a live key of a slot that does not advance.

    ``shard=(mesh, dp_axes)`` with a cache whose seq dim splits over the
    mesh's ``model`` axis: the cache is split so (batch over the data axes
    where it divides), each shard writes its own block and only the owner
    of a sample's slot writes it (:func:`write_local`), and the blocks are
    gathered back; the same values as the unsharded write."""
    size = buf.shape[1]
    idx = write_index(lengths, size, window)
    if shard is not None:
        mesh, dp_axes = shard
        msize = mesh.shape.get("model", 1)
        if msize > 1 and size % msize == 0:
            return _write_sharded(buf, new, idx, mesh, dp_axes)
    out = buf.clone()
    out[torch.arange(buf.shape[0], device=buf.device), idx] = \
        new[:, 0].to(buf.dtype)
    return out


def write_local(buf, new, idx, offset: int):
    """A copy of one shard's cache block ``buf`` (B, s_loc, H, D), which
    holds the slots ``offset`` .. ``offset + s_loc - 1``, with ``new``
    (B, 1, H, D) written at each sample's slot ``idx`` (B,) where the
    block owns it; every other sample's block is left as it was. No host
    read: the owner test is a ``where`` on the device."""
    s_loc = buf.shape[1]
    li = idx - offset
    ok = (li >= 0) & (li < s_loc)
    lc = li.clamp(0, s_loc - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    out = buf.clone()
    cur = out[rows, lc]
    out[rows, lc] = torch.where(ok[:, None, None], new[:, 0].to(buf.dtype),
                                cur)
    return out


def _write_sharded(buf, new, idx, mesh, dp_axes):
    from repro_torch.distribution import sharding as shd
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    B = buf.shape[0]
    bspec = shd.spec_entry(dp) if dp and B % shd.axis_size(mesh, dp) == 0 \
        else None
    cspec = (bspec, "model")
    s_loc = buf.shape[1] // mesh.shape["model"]
    outs = []
    for i in range(mesh.size):
        b = shd.take_block(buf, cspec, mesh, i)
        n = shd.take_block(new, (bspec,), mesh, i)
        j = shd.take_block(idx, (bspec,), mesh, i)
        outs.append(write_local(b, n, j, mesh.axis_index(i, "model") * s_loc))
    return shd.gather_tree(tuple(outs), [cspec], mesh)


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
