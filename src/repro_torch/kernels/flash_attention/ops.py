"""Wrapper of the flash-attention kernels.

Two CUDA kernels compute the same function; which one runs is a static
choice by (dtype, head dim), made by :func:`impl_for` and never by a
failure: a build or launch error of either raises.

- ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bfloat16 at head dims
  64, 128 and 256, on the tensor cores (TMA-fed ``wgmma``, p split into
  bf16 hi and lo halves for the PV product).
- ``"scalar"`` (``csrc/flash_attention.cu``): float32 at every head dim,
  and bfloat16 at head dims 16 and 32, whose 32- and 64-byte rows are
  narrower than the 128-byte swizzled boxes the wgmma kernel reads. It
  runs on the float32 FMA units.

A CPU tensor takes the plain version in ``ref.py``. ``LAUNCHES`` counts
kernel launches, ``LAUNCHES_BY_IMPL`` the same per kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = 0
LAUNCHES_BY_IMPL = {"wgmma": 0, "scalar": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)   # the scalar kernel's template instances
WGMMA_HEAD_DIMS = (64, 128, 256)     # the wgmma kernel's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def impl_for(dtype, D: int) -> str:
    """The kernel that computes attention for this dtype and head dim:
    ``"wgmma"`` or ``"scalar"``."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "scalar"


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                    scale=None):
    """Causal GQA attention in the model layout: q (B, S, H, D); k, v
    (B, S, Hkv, D), float32 or bfloat16, all one dtype; q head h reads kv
    head h // (H // Hkv). ``window`` > 0 keeps keys with
    0 <= q_pos - k_pos < window; ``softcap`` > 0 applies
    ``tanh(s / softcap) * softcap`` before the mask. ``scale`` defaults to
    1/sqrt(D). Returns (B, S, H, D) in q's dtype."""
    global LAUNCHES
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}, expected float32 "
                        "or bfloat16")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} q heads over {Hkv} kv heads")
    _build.require("q", q, q.dtype, (B, S, H, D), dev)
    _build.require("k", k, q.dtype, (B, S, Hkv, D), dev)
    _build.require("v", v, q.dtype, (B, S, Hkv, D), dev)
    if window < 0 or softcap < 0:
        raise ValueError("flash_attention: window and softcap must be >= 0")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if dev.type == "cpu":
        return attention_ref(q, k, v, window=window, softcap=softcap,
                             scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    impl = impl_for(q.dtype, D)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Hkv, D, int(window), float(softcap), scale)
    with _build.on_device(dev):
        stream = _build.stream_ptr(dev)
        if impl == "wgmma":
            code = lib.flash_attention_sm90_launch(*args, stream)
        else:
            code = lib.flash_attention_launch(*args, _DTYPES[q.dtype],
                                              stream)
    _build.check(code, f"flash_attention ({impl})")
    LAUNCHES += 1
    LAUNCHES_BY_IMPL[impl] += 1
    return out
