"""Wrapper of the flash-attention kernels.

Two CUDA kernels compute the same function; which one runs is a static
choice by (dtype, head dim), made by :func:`impl_for` and never by a
failure: a build or launch error of either raises.

- ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bfloat16 and float16
  at every head dim that is a multiple of 8 up to 256, on the tensor
  cores (TMA-fed ``wgmma``, p split into hi and lo halves of the input
  type for the PV product). Its instances are 64, 128 and 256 columns
  wide; a head dim runs on the narrowest that holds it, TMA filling the
  columns past D with zeros on load and clipping them on the store (D %
  8 == 0 keeps every row 16-byte aligned, as TMA needs).
- ``"scalar"`` (``csrc/flash_attention.cu``): every other (dtype, head
  dim): float32 at every D, and bfloat16 and float16 at D % 8 != 0 or D >
  256. It runs on the float32 FMA units as a register-tiled product, 64
  q rows x 64 keys a tile, the output accumulator in registers. Up to D
  = 128 a "narrow" block of 128 threads (instances 64 and 128 columns
  wide, columns past D read as zeros) gives each thread an 8 x 4
  micro-tile of scores (rows ty + 8 i, keys tx + 16 j). Above, a "wide"
  block of 256 threads gives each a 4 x 4 micro-tile and computes each
  tile's scores once over all of D, Q and K staged in 64-column chunks;
  it holds up to 384 output columns (instances of 256, 320 and 384), and
  a larger D splits its output columns over blocks.

Both take a query offset (:func:`flash_attention`'s ``q_offset``): q
holds Sq rows at positions ``q_offset`` .. ``q_offset + Sq - 1`` against
Skv >= q_offset + Sq keys, the launch of one context-parallel shard.

Both also write each row's logsumexp of its scores when
:func:`flash_attention` is given an ``lse`` tensor (training asks for it);
without one they store nothing else and the output keeps its bits.

The gradient, :func:`flash_attention_backward`, is four launches, no
float atomics and no (Sq, Skv) buffer: it recomputes the scores tile by
tile from the forward's logsumexp. Three instances, chosen by
:func:`bwd_impl_for` as statically as the forward's (``BWD_KERNELS`` names
each one's launches):

- ``"wgmma"``: bfloat16 and float16 at D % 8 == 0 and D <= 256 (the
  forward's wgmma domain). ``"dot"`` (delta = sum dout * out per row,
  ``csrc/flash_attention_bwd.cu``); ``"dkdv_wgmma"`` (each q head's
  float32 share of dK and dV per 128-key block, on the tensor cores,
  ``csrc/flash_attention_bwd_sm90.cu``); ``"dkdv_sum"`` (dK and dV, the
  sum of a kv head's shares in head order); ``"dq_wgmma"`` (dQ per 128-row
  block, on the tensor cores). P and dS enter their products as hi and lo
  halves of the input type.
- ``"tf32"``: float32 at D <= 128, and bfloat16 and float16 at D % 8 != 0
  and D <= 128 (their values are exact in TF32), on the tensor cores in
  TF32 from big and small halves of every float32 operand (three products
  a product, four for S and dP; ``csrc/flash_attention_bwd_tf32.cu``):
  ``"split_tf32"`` (the split pass: delta as ``"dot"`` computes it, and Q,
  dO, K and V as TF32 halves in the model layout padded to DW = 64 or 128
  columns; K also transposed, and at DW = 64 Q and dO too, since wgmma
  takes 32-bit operands K-major only; one float32 workspace freed after
  the call, whose layout only the C side knows and whose size
  ``flash_bwd_tf32_workspace_floats`` gives: 4 (B Sq H + B Skv Hkv) DW +
  2 B Hkv DW Skv' floats (S' = S rounded up to 32), and 4 B H DW Sq' more
  at DW = 64: 117.4 MB at qwen3's heads and 2048 tokens); ``"dkdv_tf32"`` (each q head's share
  per 64-key block; at DW = 128 it transposes its streamed Q and dO in
  shared memory itself), ``"dkdv_sum"``, ``"dq_tf32"`` (dQ per 64-row
  block). It stops at 128 columns: a CTA keeps 64 resident rows of two
  tensors in two 4-byte halves (128 KB at DW = 128) beside its ring of
  streamed tiles in a block's 227 KB of shared memory, and 256 columns
  would take all of it for the resident rows alone.
- ``"fma"``: what is left, D > 128 in float32 and D > 128 at D % 8 != 0 or
  D > 256 in 16 bits: ``"dot"``, ``"dkdv"`` (per 64-key block),
  ``"dkdv_sum"`` and ``"dq"`` (per 64-row block), all in
  ``csrc/flash_attention_bwd.cu`` on the float32 FMA units.

A CPU tensor takes the plain versions in ``ref.py``. ``LAUNCHES`` counts
forward kernel launches, ``LAUNCHES_BY_IMPL`` the same per kernel, and
``LAUNCHES_BY_OFFSET`` the same per (kernel, ``q_offset``);
``LAUNCHES_BWD`` counts the backward's kernel launches (four a call) and
``LAUNCHES_BWD_BY_KERNEL`` the same per kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_backward_ref,
                                                    attention_lse_ref,
                                                    attention_ref)

LAUNCHES = 0
LAUNCHES_BY_IMPL = {"wgmma": 0, "scalar": 0}
LAUNCHES_BY_OFFSET = {}               # (impl, q_offset) -> launches
WGMMA_WIDTHS = (64, 128, 256)        # the wgmma kernel's instance widths
# q rows a block of each kernel computes: an offset launch's rows equal a
# full launch's bit for bit when the offset is a multiple of it
Q_BLOCK = {"wgmma": 128, "scalar": 64}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the gradient's four launches in order, per instance (bwd_impl_for)
BWD_KERNELS = {"wgmma": ("dot", "dkdv_wgmma", "dkdv_sum", "dq_wgmma"),
               "tf32": ("split_tf32", "dkdv_tf32", "dkdv_sum", "dq_tf32"),
               "fma": ("dot", "dkdv", "dkdv_sum", "dq")}
# each instance's ``split`` argument of ref.backward_error_bound
BWD_SPLIT = {"wgmma": True, "tf32": "tf32", "fma": False}
TF32_MAX_D = 128           # the tf32 instance's widest head dim
LAUNCHES_BWD = 0
LAUNCHES_BWD_BY_KERNEL = dict.fromkeys(
    [k for kernels in BWD_KERNELS.values() for k in kernels], 0)


def impl_for(dtype, D: int) -> str:
    """The kernel that computes attention for this dtype and head dim:
    ``"wgmma"`` for bfloat16 and float16 at D % 8 == 0 and D <= 256,
    ``"scalar"`` for the rest. A static choice, never made by a failure."""
    if (dtype in (torch.bfloat16, torch.float16) and D % 8 == 0
            and D <= WGMMA_WIDTHS[-1]):
        return "wgmma"
    return "scalar"


def bwd_impl_for(dtype, D: int) -> str:
    """The gradient's instance for this dtype and head dim: ``"wgmma"``
    where the forward runs on the tensor cores (bfloat16 and float16 at D %
    8 == 0 and D <= 256), ``"tf32"`` for the rest up to D = 128 (float32 at
    every such D), ``"fma"`` above. A static choice, never made by a
    failure."""
    if impl_for(dtype, D) == "wgmma":
        return "wgmma"
    return "tf32" if D <= TF32_MAX_D else "fma"


def _check(name, q, k, v, window, softcap, q_offset):
    """Validate the arguments the forward and the backward share; returns
    (B, Sq, H, D, Skv, Hkv)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q is {q.dtype}, expected float32, "
                        "bfloat16 or float16")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: {H} q heads over {Hkv} kv heads")
    if q_offset < 0 or q_offset + Sq > Skv:
        raise ValueError(f"{name}: {Sq} query rows at offset "
                         f"{q_offset} against {Skv} keys")
    _build.require("q", q, q.dtype, (B, Sq, H, D), dev)
    _build.require("k", k, q.dtype, (B, Skv, Hkv, D), dev)
    _build.require("v", v, q.dtype, (B, Skv, Hkv, D), dev)
    if window < 0 or softcap < 0:
        raise ValueError(f"{name}: window and softcap must be >= 0")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return B, Sq, H, D, Skv, Hkv


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                    scale=None, q_offset: int = 0, lse=None):
    """Causal GQA attention in the model layout: q (B, Sq, H, D); k, v
    (B, Skv, Hkv, D), float32, bfloat16 or float16, all one dtype, any
    head dim D >= 1; q head h reads kv head h // (H // Hkv). Query row i
    sits at position ``q_offset + i`` and keys at 0..Skv-1, with
    ``q_offset + Sq <= Skv``; a key is seen by a query at or after its
    position. ``window`` > 0 keeps keys with 0 <= q_pos - k_pos <
    window; ``softcap`` > 0 applies ``tanh(s / softcap) * softcap``
    before the mask. ``scale`` defaults to 1/sqrt(D). Returns (B, Sq, H,
    D) in q's dtype. ``lse``, a float32 (B, H, Sq) tensor on q's device,
    receives each row's logsumexp of its (scaled, softcapped, masked)
    scores, the input of :func:`flash_attention_backward`."""
    global LAUNCHES
    q_offset = int(q_offset)
    B, Sq, H, D, Skv, Hkv = _check("flash_attention", q, k, v, window,
                                   softcap, q_offset)
    if lse is not None:
        _build.require("lse", lse, torch.float32, (B, H, Sq), q.device)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        kw = dict(window=window, softcap=softcap, scale=scale,
                  q_offset=q_offset)
        if lse is None:
            return attention_ref(q, k, v, **kw)
        out, rows = attention_lse_ref(q, k, v, **kw)
        lse.copy_(rows)
        return out
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    impl = impl_for(q.dtype, D)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Skv, q_offset, H,
            Hkv, D, int(window), float(softcap), scale)
    with _build.on_device(dev):
        stream = _build.stream_ptr(dev)
        launch = (lib.flash_attention_sm90_launch if impl == "wgmma"
                  else lib.flash_attention_launch)
        code = launch(*args, _DTYPES[q.dtype], stream)
    _build.check(code, f"flash_attention ({impl})")
    LAUNCHES += 1
    LAUNCHES_BY_IMPL[impl] += 1
    key = (impl, q_offset)
    LAUNCHES_BY_OFFSET[key] = LAUNCHES_BY_OFFSET.get(key, 0) + 1
    return out


def flash_attention_backward(q, k, v, out, dout, lse, *, window: int = 0,
                             softcap: float = 0.0, scale=None,
                             q_offset: int = 0):
    """The gradient (dq, dk, dv) of :func:`flash_attention` at ``dout``,
    from its inputs, its output ``out`` and its ``lse`` (float32 (B, H,
    Sq)), with the forward's ``window``, ``softcap``, ``scale`` and
    ``q_offset``; each gradient in its input's dtype and shape. On the card
    four launches of the instance :func:`bwd_impl_for` names (delta, each q
    head's share of dK/dV, their sum, dQ) and a float32 (2, B, Skv, H, D)
    buffer of the shares; a CPU tensor takes ``attention_backward_ref``."""
    global LAUNCHES_BWD
    q_offset = int(q_offset)
    B, Sq, H, D, Skv, Hkv = _check("flash_attention_backward", q, k, v,
                                   window, softcap, q_offset)
    dev = q.device
    _build.require("out", out, q.dtype, (B, Sq, H, D), dev)
    _build.require("dout", dout, q.dtype, (B, Sq, H, D), dev)
    _build.require("lse", lse, torch.float32, (B, H, Sq), dev)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if dev.type == "cpu":
        return attention_backward_ref(q, k, v, out, dout, lse, window=window,
                                      softcap=softcap, scale=scale,
                                      q_offset=q_offset)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=dev)
    delta = torch.empty((B, H, Sq), **f32)
    part = torch.empty((2, B, Skv, H, D), **f32)
    lib = _build.library()
    dtype = _DTYPES[q.dtype]
    shape = (B, Sq, Skv, q_offset, H, Hkv, D, int(window), float(softcap),
             scale)
    ptr = lambda *ts: tuple(t.data_ptr() for t in ts)
    impl = bwd_impl_for(q.dtype, D)
    first, dkdv, dkdv_sum, dq_kernel = BWD_KERNELS[impl]
    sum_args = (*ptr(part, dk, dv), dk.numel(), H // Hkv, D, dtype)
    if impl == "tf32":
        # the split planes' workspace (its layout is the C side's alone)
        ws = torch.empty(lib.flash_bwd_tf32_workspace_floats(
            B, Sq, Skv, H, Hkv, D), **f32)
        launches = [
            (first, (*ptr(q, k, v, out, dout, delta, ws), B, Sq, Skv, H, Hkv,
                     D, dtype)),
            (dkdv, (*ptr(ws, lse, delta, part), *shape)),
            (dkdv_sum, sum_args),
            (dq_kernel, (*ptr(ws, lse, delta, dq), *shape, dtype))]
    else:
        launches = [
            (first, (*ptr(out, dout, delta), B, Sq, H, D, dtype)),
            (dkdv, (*ptr(q, k, v, dout, lse, delta, part), *shape, dtype)),
            (dkdv_sum, sum_args),
            (dq_kernel, (*ptr(q, k, v, dout, lse, delta, dq), *shape,
                         dtype))]
    with _build.on_device(dev):
        stream = _build.stream_ptr(dev)
        for kernel, args in launches:
            code = getattr(lib, f"flash_bwd_{kernel}_launch")(*args, stream)
            _build.check(code, f"flash_attention_backward ({kernel})")
            LAUNCHES_BWD += 1
            LAUNCHES_BWD_BY_KERNEL[kernel] += 1
    return dq, dk, dv
