"""Mixture-of-Experts FFN with capacity-based sort/scatter dispatch — port
of ``repro.models.moe`` (the dense, single-device path).

Dispatch sorts the (token, expert) assignments by expert (a stable
argsort), ranks each within its expert (``searchsorted``), drops those
beyond the capacity C and writes the kept ones into an (E, C, d) buffer;
the expert FFN is three batched products over that buffer, and the
combine brings the outputs back to (T, d).

Every step is free of atomics, so two calls on the card give the same
bits: the kept assignments hold distinct (expert, slot) pairs, so the
buffer is written by plain assignment (the dropped ones all land in one
spare row that nothing reads), and each token's k contributions are
summed in a fixed order, ascending expert id, the order in which the
reference's scatter-add meets them after its stable sort.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, rms_norm_defs
from repro_torch.models.param import ParamDef


def moe_defs(cfg) -> dict:
    d = cfg.d_model
    m = cfg.moe
    dt = dtype_of(cfg.param_dtype)
    s = 0.02
    exp = ("experts", "d_model", "d_ff")
    return {
        "norm": rms_norm_defs(d, dt),
        "router": ParamDef((d, m.n_experts), ("d_model", "experts_router"),
                           dt, "normal", s),
        "w_gate": ParamDef((m.n_experts, d, m.d_ff_expert), exp, dt,
                           "normal", s),
        "w_up": ParamDef((m.n_experts, d, m.d_ff_expert), exp, dt, "normal",
                         s),
        "w_down": ParamDef((m.n_experts, m.d_ff_expert, d),
                           ("experts", "d_ff", "d_model"), dt, "normal",
                           s / math.sqrt(2 * cfg.n_layers)),
    }


def capacity(n_tokens: int, m) -> int:
    return max(1, int(math.ceil(n_tokens * m.experts_per_token
                                * m.capacity_factor / m.n_experts)))


def moe_apply(p, x, cfg, counts=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32).

    ``counts``: a list to which the call appends a (2,) int64 device tensor,
    (dropped, total) assignments; nothing is read back to the host."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k = m.experts_per_token
    E = m.n_experts
    C = capacity(T, m)
    dev = x.device
    xt = x.reshape(T, d)

    logits = (xt @ p["router"].to(xt.dtype)).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch-style load-balancing auxiliary loss
    density = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    density_proxy = probs.mean(0)
    aux = torch.sum(density * density_proxy) * E * m.aux_loss_weight

    # ---- sort/scatter dispatch -------------------------------------------
    flat_expert = expert_ids.reshape(-1)                            # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)                # by expert
    sorted_expert = flat_expert[order]
    # rank of each assignment within its expert group
    pos = torch.arange(T * k, device=dev)
    group_start = torch.searchsorted(sorted_expert,
                                     torch.arange(E, device=dev))
    rank = pos - group_start[sorted_expert]
    keep = rank < C
    src_token = order // k             # flat index t * k + j -> token t
    # a kept assignment's buffer row; every dropped one, the spare row E*C
    row = torch.where(keep, sorted_expert * C + rank, E * C)
    buf = x.new_zeros((E * C + 1, d))
    buf[row] = xt[src_token]
    buf = buf[:E * C].reshape(E, C, d)

    # ---- expert FFN (dense over E*C slots) -------------------------------
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p["w_down"].to(x.dtype))                     # (E, C, d)

    # ---- combine back ----------------------------------------------------
    y = torch.cat([y.reshape(E * C, d), x.new_zeros((1, d))])
    gate = torch.where(keep, flat_gate[order], 0.0).to(x.dtype)
    weighted = y[row] * gate[:, None]                  # (T*k, d), sorted
    # each token's k contributions in sorted order = ascending expert id
    where = torch.empty_like(order)
    where[order] = pos
    ranked = where.reshape(T, k).sort(dim=-1).values
    out = weighted[ranked[:, 0]]
    for j in range(1, k):
        out = out + weighted[ranked[:, j]]
    if counts is not None:
        dropped = (~keep).sum()
        counts.append(torch.stack([dropped, torch.full_like(dropped,
                                                            T * k)]))
    return out.reshape(B, S, d), aux
