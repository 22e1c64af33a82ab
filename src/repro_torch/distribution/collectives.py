"""Collectives over a ``ModelMesh``'s shards, in one process.

A sharded value is a list with one tensor per shard (mesh order). A
collective over a mesh axis (or axes) combines each group of shards that
differ only along it (``ModelMesh.groups``) and hands every member its
result on its own device:

  * :func:`psum` — the sum, added in the group's fixed order
    ``((x0 + x1) + x2) + ...`` on the first member's device;
  * :func:`all_gather` — the blocks concatenated along ``dim`` in group
    order;
  * :func:`reduce_scatter` — the sum, split along ``dim``, block j to
    member j;
  * :func:`all_to_all` — member j gets block j of every member's tensor
    (split along one dim), concatenated along another in group order: the
    reshard of context parallelism, from column blocks to row blocks and
    back.

Every sum is a chain of plain adds in shard order, with no atomics, so two
runs give the same bits. Each is an autograd Function whose backward is
the conjugate collective, in the same fixed order: psum's is psum,
all_gather's is reduce_scatter, reduce_scatter's is all_gather and
all_to_all's is the all_to_all that puts every block back. A
group of one shard returns its tensor itself (no copy, no graph node), so
a one-shard mesh runs exactly the unsharded ops.

One process drives every shard (logical shards on one card, or one
process over the cards of a host), so ``torch.distributed`` is not
needed; this module is the one place a multi-process run would swap for
NCCL's collectives. ``CALLS`` counts the calls that combined more than
one shard, by kind.
"""
from __future__ import annotations

import torch

CALLS = {"psum": 0, "all_gather": 0, "reduce_scatter": 0, "all_to_all": 0}


def ordered_sum(xs):
    """``((x0 + x1) + x2) + ...`` on the first tensor's device, skipping
    Nones: the one order every collective adds in."""
    dev = next(x.device for x in xs if x is not None)
    total = None
    for x in xs:
        if x is None:
            continue
        x = x.to(dev)
        total = x if total is None else total + x
    return total


def _spread(t, devices):
    """``t`` to every member: the first gets ``t`` itself, the others a
    copy on their device (no two members share a tensor)."""
    return tuple(t if j == 0 else t.to(d, copy=True)
                 for j, d in enumerate(devices))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return _spread(ordered_sum(xs), ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None,) * len(gs)
        return _spread(ordered_sum(gs), ctx.devices)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        full = torch.cat([x.to(ctx.devices[0]) for x in xs], dim=dim)
        return _spread(full, ctx.devices)

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return (None,) * (len(gs) + 1)
        parts = ordered_sum(gs).split(ctx.sizes, dim=ctx.dim)
        return (None,) + tuple(p.to(d).contiguous()
                               for p, d in zip(parts, ctx.devices))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        ctx.devices = [x.device for x in xs]
        parts = ordered_sum(xs).chunk(len(xs), dim=dim)
        ctx.part = parts[0].shape
        return tuple(p.to(d, copy=True).contiguous()
                     for p, d in zip(parts, ctx.devices))

    @staticmethod
    def backward(ctx, *gs):
        dev = ctx.devices[0]
        full = torch.cat([torch.zeros(ctx.part, device=dev) if g is None
                          else g.to(dev) for g in gs], dim=ctx.dim)
        return (None,) + _spread(full, ctx.devices)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, cat_dim, sizes, *xs):
        ctx.dims = (split_dim, cat_dim)
        ctx.devices = [x.device for x in xs]
        ctx.sizes = list(sizes)
        ctx.cat_sizes = [x.shape[cat_dim] for x in xs]
        parts = [x.split(ctx.sizes, dim=split_dim) for x in xs]
        out = tuple(torch.cat([p[j].to(d) for p in parts], dim=cat_dim)
                    for j, d in enumerate(ctx.devices))
        ctx.shapes = [o.shape for o in out]
        ctx.dtype = xs[0].dtype
        return out

    @staticmethod
    def backward(ctx, *gs):
        split_dim, cat_dim = ctx.dims
        gs = [torch.zeros(sh, dtype=ctx.dtype, device=d) if g is None else g
              for g, sh, d in zip(gs, ctx.shapes, ctx.devices)]
        parts = [g.split(ctx.cat_sizes, dim=cat_dim) for g in gs]
        return (None, None, None) + tuple(
            torch.cat([p[i].to(d) for p in parts], dim=split_dim)
            for i, d in enumerate(ctx.devices))


def _run(kind, fn, xs, mesh, axes, *args):
    out = list(xs)
    for group in mesh.groups(axes):
        if len(group) == 1:
            continue
        CALLS[kind] += 1
        res = fn(*args, *[xs[i] for i in group])
        for i, r in zip(group, res):
            out[i] = r
    return out


def psum(xs, mesh, axes) -> list:
    """The sum over ``axes`` (a name or a tuple; axes not in the mesh are
    skipped), every member holding it."""
    return _run("psum", _PSum.apply, xs, mesh, axes)


def pmean(xs, mesh, axes) -> list:
    """:func:`psum` over the group's size (a division by a 0-d tensor, as
    ``train.optimizer._div``, so the card rounds as a division)."""
    from repro_torch.distribution.sharding import axis_size
    n = axis_size(mesh, tuple(a for a in ((axes,) if isinstance(axes, str)
                                          else axes) if a in mesh.shape))
    if n == 1:
        return list(xs)
    return [s / torch.full((), float(n), dtype=s.dtype, device=s.device)
            for s in psum(xs, mesh, axes)]


def all_gather(xs, mesh, axes, dim: int) -> list:
    """The blocks over ``axes`` concatenated along ``dim``."""
    return _run("all_gather", _AllGather.apply, xs, mesh, axes, dim)


def reduce_scatter(xs, mesh, axes, dim: int) -> list:
    """The sum over ``axes``, split along ``dim`` (member j gets block
    j)."""
    return _run("reduce_scatter", _ReduceScatter.apply, xs, mesh, axes, dim)


def all_to_all(xs, mesh, axes, split_dim: int, cat_dim: int,
               sizes=None) -> list:
    """Member j of each group over ``axes`` gets the j-th block along
    ``split_dim`` of every member's tensor, concatenated along ``cat_dim``
    in group order. ``sizes``: the blocks' lengths along ``split_dim``
    (default equal blocks); a block may be empty."""
    out = list(xs)
    for group in mesh.groups(axes):
        if len(group) == 1:
            continue
        n = len(group)
        sz = sizes
        if sz is None:
            per = xs[group[0]].shape[split_dim] // n
            sz = [per] * n
        if len(sz) != n:
            raise ValueError(f"all_to_all: {len(sz)} block sizes for a "
                             f"group of {n}")
        CALLS["all_to_all"] += 1
        res = _AllToAll.apply(split_dim, cat_dim, tuple(sz),
                              *[xs[i] for i in group])
        for i, r in zip(group, res):
            out[i] = r
    return out
