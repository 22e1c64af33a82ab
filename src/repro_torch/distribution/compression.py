"""Int8 error-feedback gradient compression — port of
``repro.distribution.compression``.

Each gradient leaf is quantized to int8 with a per-leaf scale (its max
absolute value over 127, floored at 1e-12); the quantization error is kept
in a float32 error-feedback buffer and added back at the next step
(EF-SGD), which keeps convergence while cutting gradient-sync bytes 4x
(float32) or 2x (bfloat16).

As in the reference, nothing wires it into the train step:
``TrainConfig.grad_compression`` is declared and read nowhere. It is the
transform a multi-card step would apply before its gradient reduction.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.train import tree as tr


class EFState(NamedTuple):
    error: dict  # tree of float32 error-feedback buffers


def init_ef(params) -> EFState:
    return EFState(error=tr.map_(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def _quantize(x):
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / torch.full((), 127.0, dtype=x.dtype,
                                          device=x.device), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def compress_leaf(g, err):
    """Returns (int8 payload, scale, new_error); g and err of one shape."""
    target = g.to(torch.float32) + err
    q, scale = _quantize(target)
    recon = _dequantize(q, scale)
    return q, scale, target - recon


def compress_grads(grads, ef: EFState) -> Tuple[dict, dict, EFState]:
    """Compress every leaf. Returns (q_tree, scale_tree, new_ef)."""
    flat_g, treedef = tr.flatten(grads)
    out = [compress_leaf(g, e) for g, e in zip(flat_g, tr.leaves(ef.error))]
    un = lambda i: tr.unflatten(treedef, [o[i] for o in out])
    return un(0), un(1), EFState(error=un(2))


def decompress_grads(q_tree, scale_tree):
    return tr.map_(_dequantize, q_tree, scale_tree)


def roundtrip(grads, ef: EFState):
    """compress -> (a simulated sync) -> decompress, with error feedback."""
    q, s, ef = compress_grads(grads, ef)
    return decompress_grads(q, s), ef
