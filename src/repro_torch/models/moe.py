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


def _route(p, xt, m, E: int):
    """Router probs, top-k gates (renormalised) and expert ids, and the
    Switch-style load-balancing aux loss over the tokens of ``xt``."""
    logits = (xt @ p["router"].to(xt.dtype)).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    density = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    density_proxy = probs.mean(0)
    aux = torch.sum(density * density_proxy) * E * m.aux_loss_weight
    return gate_vals, expert_ids, aux


def _dispatch(p, x, xt, expert_ids, gate_vals, E_loc: int, offset: int,
              C: int, counts=None):
    """Sort/scatter dispatch of the assignments to experts ``offset`` ..
    ``offset + E_loc - 1`` (the weights ``p`` holds), their FFN, and the
    combine back to (T, d); an assignment to any other expert contributes
    nothing. Returns (T, d)."""
    T, d = xt.shape
    k = expert_ids.shape[1]
    dev = x.device
    flat_expert = expert_ids.reshape(-1) - offset                   # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    in_range = (flat_expert >= 0) & (flat_expert < E_loc)
    key = torch.where(in_range, flat_expert, E_loc)
    order = torch.argsort(key, stable=True)                        # by expert
    sorted_expert = key[order]
    # rank of each assignment within its expert group
    pos = torch.arange(T * k, device=dev)
    group_start = torch.searchsorted(sorted_expert,
                                     torch.arange(E_loc, device=dev))
    rank = pos - group_start[sorted_expert.clamp(max=E_loc - 1)]
    keep = (sorted_expert < E_loc) & (rank < C)
    src_token = order // k             # flat index t * k + j -> token t
    # a kept assignment's buffer row; every other one, the spare row
    row = torch.where(keep, sorted_expert * C + rank, E_loc * C)
    buf = x.new_zeros((E_loc * C + 1, d))
    buf[row] = xt[src_token]
    buf = buf[:E_loc * C].reshape(E_loc, C, d)

    # ---- expert FFN (dense over E*C slots) -------------------------------
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p["w_down"].to(x.dtype))                     # (E, C, d)

    # ---- combine back ----------------------------------------------------
    y = torch.cat([y.reshape(E_loc * C, d), x.new_zeros((1, d))])
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
        mine = in_range[order]
        dropped = (mine & ~keep).sum()
        counts.append(torch.stack([dropped, mine.sum()]))
    return out


def moe_apply(p, x, cfg, counts=None, shard=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32).

    ``counts``: a list to which the call appends a (2,) int64 device tensor,
    (dropped, total) assignments (one per shard on a mesh); nothing is read
    back to the host. ``shard=(mesh, dp_axes)``: expert parallelism
    (:func:`moe_apply_sharded`) when the mesh's ``model`` axis is larger
    than 1 and divides the expert count, as the reference picks it; the
    dense path otherwise."""
    m = cfg.moe
    if shard is not None:
        mesh, dp = shard
        msize = mesh.shape.get("model", 1)
        if msize > 1 and m.n_experts % msize == 0:
            return moe_apply_sharded(p, x, cfg, mesh, dp, counts=counts)
    B, S, d = x.shape
    T = B * S
    E = m.n_experts
    xt = x.reshape(T, d)
    gate_vals, expert_ids, aux = _route(p, xt, m, E)
    out = _dispatch(p, x, xt, expert_ids, gate_vals, E, 0, capacity(T, m),
                    counts)
    return out.reshape(B, S, d), aux


def moe_shards(ps, xs, cfg, mesh, dp_axes, counts=None):
    """Expert parallelism over ``mesh``'s ``model`` axis, per shard: shard
    i holds its data block of tokens ``xs[i]`` (B / n_dp, S, d) and, in
    ``ps[i]``, the whole router and its block of E / m experts. Each shard
    dispatches its tokens to its local experts alone (capacity from the
    local count ``T_loc = (B / n_dp) * S``, as the reference's
    ``shard_map`` body); the combine is one ``psum`` over ``model`` and the
    aux loss a ``pmean`` over the data axes. Returns (outs, auxes), lists
    over the shards."""
    from repro_torch.distribution import collectives as col
    m = cfg.moe
    E = m.n_experts
    msize = mesh.shape["model"]
    if E % msize:
        raise ValueError(f"{E} experts do not split over model={msize}")
    E_loc = E // msize
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    outs, auxes = [], []
    for i, (p, x) in enumerate(zip(ps, xs)):
        B, S, d = x.shape
        T = B * S
        xt = x.reshape(T, d)
        gate_vals, expert_ids, aux = _route(p, xt, m, E)
        off = mesh.axis_index(i, "model") * E_loc
        out = _dispatch(p, x, xt, expert_ids, gate_vals, E_loc, off,
                        capacity(T, m), counts)
        outs.append(out.reshape(B, S, d))
        auxes.append(aux)
    if dp:
        auxes = col.pmean(auxes, mesh, dp)
    return col.psum(outs, mesh, "model"), auxes


def moe_apply_sharded(p, x, cfg, mesh, dp_axes, counts=None):
    """The reference's ``moe_apply_sharded`` on global tensors: ``x``
    split over the data axes (its batch must divide their size), the
    expert weights over ``model``, :func:`moe_shards`, and the output
    gathered back. Returns (out (B, S, d), aux)."""
    from repro_torch.distribution import sharding as shd
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    ndp = shd.axis_size(mesh, dp)
    if x.shape[0] % ndp:
        raise ValueError(f"batch {x.shape[0]} does not split over {dp}")
    xspec = (shd.spec_entry(dp),) if dp else ()
    pspec = {k: (("model",) if k in ("w_gate", "w_up", "w_down") else ())
             for k in p}
    xs = [shd.take_block(x, xspec, mesh, i) for i in range(mesh.size)]
    ps = shd.place_tree(p, pspec, mesh)
    outs, auxes = moe_shards(ps, xs, cfg, mesh, dp, counts=counts)
    return shd.gather_tree(tuple(outs), [xspec], mesh), auxes[0]
