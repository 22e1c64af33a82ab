"""Env-axis sharding — the env half of ``repro.distribution.sharding``.

The scan engines are data-parallel over the env rows: per-env state rows
never interact, so E rows split over N devices into N shards of E/N rows,
each shard runs the unsharded engine over its own rows, and the outputs
gather back bit for bit (``core.pipeline.make_run_many_sharded``). The
port has no ``shard_map``: a sharded tree is a tuple of per-shard trees,
one per mesh device, each on its device.

An :class:`EnvMesh` is a tuple of ``torch.device``. It may name one device
more than once: N *logical* shards on one card run exactly the code of N
real ones (their rows split, run apart and gathered back), which is how
the tests and ``chip_smoke.py`` show the shard logic on one device, the
counterpart of the reference's ``--xla_force_host_platform_device_count``
recipe. :func:`visible_devices` is the one place that lists devices;
replace it to get logical shards::

    sharding.visible_devices = lambda device: [torch.device("cpu")] * 4

Placement follows the reference's rank rule (:func:`env_specs`): a leaf
with more dims than ``env_axis`` splits on it, anything smaller (the
``tick_index``, ``have_prev``, ``tick`` and ring ``cursor`` scalars) is
replicated, one copy per shard. :func:`decide_specs` replicates the
decide carry's ``policy`` subtree whatever its ranks.

The model half (the LM's params, optimizer state, caches and batches) is
the planner below: logical dim names map onto mesh axes through ordered
candidate lists, the first candidate whose axes are unused in the tensor
and whose size divides the dim winning, the dim replicated otherwise. A
spec is a tuple with one entry per dim, each ``None``, an axis name or a
tuple of axis names (the counterpart of ``PartitionSpec``); a shorter
spec leaves the remaining dims replicated. Every planner function is a
pure function of shapes, logical dims and a mesh's axis sizes (any object
with ``axis_names`` and a ``shape`` dict: :func:`make_abstract_mesh`, or
``launch.mesh.ModelMesh``), so a 256- or 512-chip mesh is planned without
a device. :func:`place_tree` and :func:`gather_tree` move a tree onto a
``ModelMesh``'s shards and back, and :func:`block` is the one statement
of which block a shard holds. The reference's ``constrain_batch`` and
``attn_constrainers`` are ``with_sharding_constraint`` hooks for GSPMD;
the port's SPMD executor (``models.model.LM`` on a mesh) holds its
activations in those layouts by construction (the batch over the data
axes; the heads, or under ``ctx`` the query rows, over ``model``; under
``seq_parallel`` the residual stream's rows over ``model``), so they have
no counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.configs.base import ShardingConfig

from repro_torch.train import tree as tr

ENV_AXIS = "data"
# the spec leaf of a leaf that every shard holds whole
REPLICATED = "replicated"


def shard_rows(j: int, n_shards: int, n_envs: int) -> slice:
    """The env rows shard ``j`` of ``n_shards`` holds: the contiguous
    block ``j * E/N`` up to ``(j + 1) * E/N``. This and :func:`row_owner`
    are the one statement of the layout."""
    per = n_envs // n_shards
    return slice(j * per, (j + 1) * per)


def row_owner(row, n_shards: int, n_envs: int):
    """``(shard, row within it)`` of global env row(s) ``row``: an int or
    an integer tensor (elementwise)."""
    per = n_envs // n_shards
    return row // per, row % per


class EnvMesh(NamedTuple):
    """The env axis (:data:`ENV_AXIS`) over ``devices``; a device may
    repeat (logical shards). Shard j holds env rows :func:`shard_rows`."""
    devices: tuple
    axis_name = ENV_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def physical(self) -> int:
        """The number of distinct devices."""
        return len(set(self.devices))

    def rows(self, j: int, n_envs: int) -> slice:
        """The env rows shard ``j`` holds (:func:`shard_rows`)."""
        return shard_rows(j, self.size, n_envs)

    def owner(self, row, n_envs: int):
        """``(shard, row within it)`` of a global env row
        (:func:`row_owner`)."""
        return row_owner(row, self.size, n_envs)


def visible_devices(device) -> list:
    """The devices a mesh may use: ``cuda:0 .. cuda:{n-1}`` for a CUDA
    ``device``, ``[device]`` otherwise (the counterpart of
    ``jax.devices()``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def env_mesh(n_envs: int, devices: Optional[Sequence] = None) -> EnvMesh:
    """The mesh over the largest count of ``devices`` (default: the CUDA
    devices) that divides ``n_envs``; one device degenerates to the
    unsharded engine."""
    devices = list(visible_devices("cuda") if devices is None else devices)
    if not devices:
        raise ValueError("env_mesh: no devices")
    n = len(devices)
    while n > 1 and n_envs % n:
        n -= 1
    return EnvMesh(tuple(torch.device(d) for d in devices[:n]))


def env_specs(tree, env_axis: int):
    """The spec tree of ``tree``: ``env_axis`` for a leaf with more dims
    than ``env_axis`` (split on it), :data:`REPLICATED` otherwise."""
    return tr.map_(lambda x: env_axis if x.dim() > env_axis else REPLICATED,
                   tree)


def decide_specs(dstate, env_axis: int):
    """:func:`env_specs` of a ``DecideState`` with the ``policy`` subtree
    replicated: a weight whose leading dim happens to divide E must not
    split, or each shard would run another slice of the policy. The
    recurrent ``carry`` is per-env ``(E, ...)`` by the certified contract
    (``analysis.certify``) and splits by the rank rule."""
    specs = env_specs(dstate, env_axis)
    return specs._replace(
        policy=tr.map_(lambda _: REPLICATED, dstate.policy))


def _check_split(flat, sflat, n: int) -> None:
    for x, s in zip(flat, sflat):
        if s != REPLICATED and x.shape[s] % n:
            raise ValueError(f"place_env_tree: dim {s} of a "
                             f"{tuple(x.shape)} leaf does not split over "
                             f"{n} shards")


def _shard_leaves(flat, sflat, mesh: EnvMesh, j: int, copy: bool) -> list:
    dev = mesh.devices[j]
    leaves = []
    for x, s in zip(flat, sflat):
        if s != REPLICATED:
            rows = mesh.rows(j, x.shape[s])
            x = x.narrow(s, rows.start, rows.stop - rows.start)
        x = x.to(dev, copy=copy)
        leaves.append(x.contiguous() if copy else x)
    return leaves


def place_env_tree(tree, env_axis: int, mesh: EnvMesh, specs=None,
                   copy: bool = True) -> tuple:
    """A tuple of per-shard trees, shard j on ``mesh.devices[j]``: split
    leaves hold shard j's rows along their spec's axis, replicated leaves
    a whole copy. ``copy=True`` makes every leaf a new
    tensor the shard owns (the decide carry's ring and cursor are written
    in place, so no two shards may share one); ``copy=False`` gives views
    where the device allows (read-only inputs such as a batch)."""
    if specs is None:
        specs = env_specs(tree, env_axis)
    flat, treedef = tr.flatten(tree)
    sflat = tr.leaves(specs)
    _check_split(flat, sflat, mesh.size)
    return tuple(tr.unflatten(treedef, _shard_leaves(flat, sflat, mesh, j,
                                                     copy))
                 for j in range(mesh.size))


def shard_of(tree, env_axis: int, mesh: EnvMesh, j: int, specs=None,
             copy: bool = False):
    """Shard ``j``'s tree of :func:`place_env_tree`, built alone (views
    by default)."""
    if specs is None:
        specs = env_specs(tree, env_axis)
    flat, treedef = tr.flatten(tree)
    sflat = tr.leaves(specs)
    _check_split(flat, sflat, mesh.size)
    return tr.unflatten(treedef, _shard_leaves(flat, sflat, mesh, j, copy))


def gather_env_tree(shards, env_axis: int, specs=None):
    """The inverse of :func:`place_env_tree`: split leaves concatenated in
    shard order on shard 0's device, replicated leaves taken from shard 0.
    One shard gives its tree itself."""
    if len(shards) == 1:
        return shards[0]
    if specs is None:
        specs = env_specs(shards[0], env_axis)
    flats = [tr.flatten(s)[0] for s in shards]
    treedef = tr.flatten(shards[0])[1]
    dev = flats[0][0].device
    leaves = []
    for parts, s in zip(zip(*flats), tr.leaves(specs)):
        if s == REPLICATED:
            leaves.append(parts[0].to(dev))
        else:
            leaves.append(torch.cat([p.to(dev) for p in parts], dim=s))
    return tr.unflatten(treedef, leaves)


def replicas_agree(shards, specs) -> bool:
    """Whether every shard holds the same bits in each replicated leaf
    (the scalars each shard advances on its own)."""
    flats = [tr.leaves(s) for s in shards]
    for parts, s in zip(zip(*flats), tr.leaves(specs)):
        if s == REPLICATED:
            ref = parts[0].cpu()
            if any(not torch.equal(p.cpu(), ref) for p in parts[1:]):
                return False
    return True


# ---------------------------------------------------------------------------
# The model half: logical dim -> mesh axis planning
# ---------------------------------------------------------------------------

class AbstractMesh(NamedTuple):
    """A mesh's axis names and sizes, no devices: what the planner reads."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_abstract_mesh(mesh_shape) -> AbstractMesh:
    """A planner-only mesh from ``((name, size), ...)``."""
    return AbstractMesh(tuple(n for n, _ in mesh_shape),
                        tuple(int(s) for _, s in mesh_shape))


# Data-parallel submesh: prefer pod+data, fall back to data alone.
DP = [("pod", "data"), ("data",)]
MODEL = [("model",)]


def param_rules(perf: ShardingConfig) -> dict:
    rules = {
        "vocab": [("model",)],
        "d_ff": [("model",)],
        "experts": [("model",)],
        "heads_flat": [("model",)],
        "kv_flat": [("model",)],
        "lru_width": [("model",)],
        # d_model only shards when nothing narrower could (embed fallback)
        "d_model": [("model",)],
    }
    if perf.embed_shard == "d_model":
        # the embedding tables go onto d_model: with 'vocab' empty,
        # resolve() gives 'model' to d_model
        rules["vocab"] = []
    return rules


def act_rules(perf: ShardingConfig, *,
              seq_parallel: Optional[bool] = None) -> dict:
    sp = perf.seq_parallel if seq_parallel is None else seq_parallel
    rules = {"batch": list(DP), "envs": list(DP)}
    if sp:
        rules["seq"] = [("model",)]
    return rules


def cache_rules(perf: ShardingConfig) -> dict:
    return {
        "batch": list(DP),
        "kv_heads": [("model",)],
        "lru_width": [("model",)],
        "heads_flat": [("model",)],
        "d_model": [],
        "rwkv_heads": [("model",)],
        # spread the KV cache over 'model' (flash-decode style): decode
        # contracts over cache_seq and combines the shards' partials
        "cache_seq": [("model",)] if perf.shard_cache_seq else [],
    }


def _axes_size(mesh, axes: Sequence[str]) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


def _present(mesh, cand) -> tuple:
    return tuple(a for a in cand if a in mesh.axis_names)


def spec_entry(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


# Dims earlier in this list get first pick of mesh axes. d_model is LAST on
# purpose: it is the fallback (the 92553-vocab embed table) and must not
# steal 'model' from d_ff/heads_flat just because it is dim 0 of a weight.
PRIORITY = ("experts", "vocab", "d_ff", "heads_flat", "kv_flat", "lru_width",
            "cache_seq", "kv_heads", "rwkv_heads", "batch", "envs", "seq",
            "heads", "head_dim", "d_model")


def resolve(shape: Sequence[int], dims: Sequence[str], mesh,
            rules: dict) -> tuple:
    """The spec of one tensor: dims in :data:`PRIORITY` order each take
    the first candidate of ``rules[dim]`` whose axes are in the mesh,
    unused in this tensor, and whose size divides the dim."""
    if len(shape) != len(dims):
        raise ValueError(f"shape {tuple(shape)} and dims {tuple(dims)}")
    order = sorted(range(len(dims)),
                   key=lambda i: (PRIORITY.index(dims[i])
                                  if dims[i] in PRIORITY else len(PRIORITY)))
    spec = [None] * len(dims)
    used: set = set()
    for i in order:
        for cand in rules.get(dims[i], []):
            axes = _present(mesh, cand)
            if not axes or any(a in used for a in axes):
                continue
            if shape[i] % _axes_size(mesh, axes) == 0:
                spec[i] = spec_entry(axes)
                used.update(axes)
                break
    return tuple(spec)


def _map_defs(fn, defs):
    from repro_torch.models import param as Pm
    return Pm.map_defs(fn, defs)


def tree_shardings(defs, mesh, rules: dict):
    """The spec tree of a ``ParamDef`` tree under ``rules``."""
    return _map_defs(lambda d: resolve(d.shape, d.dims, mesh, rules), defs)


def spec_axes(spec) -> set:
    """The mesh axes a spec uses."""
    used = set()
    for p in spec:
        if p is not None:
            used.update(p if isinstance(p, tuple) else (p,))
    return used


def zero1_spec(shape, dims, mesh, perf: ShardingConfig) -> tuple:
    """One leaf of :func:`zero1_shardings`."""
    base = resolve(shape, dims, mesh, param_rules(perf))
    if not perf.zero1:
        return base
    parts = list(base)
    used = spec_axes(parts)
    for dp_axes in DP:
        axes = _present(mesh, dp_axes)
        if not axes or any(a in used for a in axes):
            continue
        n = _axes_size(mesh, axes)
        for i, (size, part) in enumerate(zip(shape, parts)):
            # never the scan ('layers') dim of a stacked leaf
            if dims[i] == "layers":
                continue
            if part is None and size % n == 0:
                parts[i] = spec_entry(axes)
                return tuple(parts)
    return base


def zero1_shardings(defs, mesh, perf: ShardingConfig):
    """Optimizer-state specs: the param spec plus a data-axis shard on the
    first dim still replicated and divisible by it (``pod`` too when it
    divides as well); ZeRO-1: m and v split across data-parallel peers.
    ``perf.zero1=False`` gives the param specs."""
    return _map_defs(lambda d: zero1_spec(d.shape, d.dims, mesh, perf), defs)


def strip_leading_dim(spec) -> tuple:
    """The spec of one layer's slice of a layer-stacked leaf."""
    return tuple(spec)[1:]


def gather_hook(mesh, storage_specs, compute_specs):
    """ZeRO-3: a function from one subtree per shard, stored in
    ``storage_specs`` (the ZeRO layout's extra data-axis split), to the
    same subtrees in ``compute_specs``' layout, each leaf all-gathered
    over the axes its storage adds. The gather's backward reduce-scatters
    the gradients back to the storage blocks."""
    from repro_torch.distribution import collectives as col
    plan = []
    for st, cs in zip(spec_leaves(storage_specs),
                      spec_leaves(compute_specs)):
        steps = []
        for d, p in enumerate(st):
            c = cs[d] if d < len(cs) else None
            if p is not None and p != c:
                if c is not None:
                    raise ValueError(f"storage {st} is not compute {cs} "
                                     "plus a data split")
                steps.append((d, p))
        plan.append(steps)

    def hook(trees):
        flats = [tr.flatten(t) for t in trees]
        cols = [list(c) for c in zip(*[f[0] for f in flats])]
        for k, steps in enumerate(plan):
            for d, axes in steps:
                cols[k] = col.all_gather(cols[k], mesh, axes, d)
        return [tr.unflatten(flats[0][1], [c[i] for c in cols])
                for i in range(len(trees))]

    return hook


def batch_sharding(mesh, ndim: int, perf: ShardingConfig, *,
                   seq_axis: Optional[int] = None,
                   batch_size: Optional[int] = None) -> tuple:
    """The spec of a batch array: dim 0 over the data axes (the first
    candidate of :data:`DP` in the mesh that divides ``batch_size``), the
    rest replicated (``seq_axis`` over 'model')."""
    spec = [None] * ndim
    for dp_axes in DP:
        axes = _present(mesh, dp_axes)
        if not axes:
            continue
        if batch_size is not None and batch_size % _axes_size(mesh, axes):
            continue
        spec[0] = spec_entry(axes)
        break
    if seq_axis is not None:
        spec[seq_axis] = "model"
    return tuple(spec)


def replicated(mesh=None) -> tuple:
    """The spec of a leaf every shard holds whole."""
    return ()


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (``pod`` and ``data`` where
    present), major first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    """The product of ``axes``' sizes in ``mesh`` (absent axes count 1)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return int(math.prod(mesh.shape.get(a, 1) for a in axes))


# ---------------------------------------------------------------------------
# Placement on a ModelMesh
# ---------------------------------------------------------------------------

def block(shape, spec, mesh, i: int) -> tuple:
    """The slices of a ``shape`` tensor that shard ``i`` of ``mesh`` holds
    under ``spec``: a dim over axes (a1, a2, ...) splits into contiguous
    blocks, shard i holding the block of its row-major index over those
    axes (as ``shard_rows`` for envs). The one statement of the layout."""
    out = []
    for d, size in enumerate(shape):
        p = spec[d] if d < len(spec) else None
        if p is None:
            out.append(slice(0, size))
            continue
        axes = p if isinstance(p, tuple) else (p,)
        n = axis_size(mesh, axes)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({n})")
        per = size // n
        j = mesh.axis_index(i, axes)
        out.append(slice(j * per, (j + 1) * per))
    return tuple(out)


def take_block(x, spec, mesh, i: int, copy: bool = False):
    """Shard ``i``'s block of ``x`` under ``spec`` on its device."""
    for d, s in enumerate(block(x.shape, spec, mesh, i)):
        if s.stop - s.start != x.shape[d]:
            x = x.narrow(d, s.start, s.stop - s.start)
    x = x.to(mesh.device(i), copy=copy)
    return x.contiguous() if copy else x


def place_tree(tree, specs, mesh, copy: bool = False) -> tuple:
    """One tree per shard of ``mesh`` (row-major coordinate order), each
    leaf the block :func:`block` gives it, on the shard's device: views
    where the device allows (``copy=False``), private tensors
    otherwise."""
    flat, treedef = tr.flatten(tree)
    sflat = spec_leaves(specs)
    if len(sflat) != len(flat):
        raise ValueError(f"place_tree: {len(flat)} leaves, {len(sflat)} "
                         "specs")
    return tuple(tr.unflatten(treedef, [take_block(x, s, mesh, i, copy)
                                        for x, s in zip(flat, sflat)])
                 for i in range(mesh.size))


def gather_tree(shards, specs, mesh, device=None):
    """The inverse of :func:`place_tree`: every leaf assembled from its
    blocks on ``device`` (default shard 0's); where several shards hold a
    block (replicated axes), the first of them in shard order gives it."""
    sflat = spec_leaves(specs)
    flats = [tr.flatten(s)[0] for s in shards]
    treedef = tr.flatten(shards[0])[1]
    dev = flats[0][0].device if device is None else torch.device(device)
    leaves = []
    for k, s in enumerate(sflat):
        first = flats[0][k]
        shape = list(first.shape)
        for d in range(len(shape)):
            p = s[d] if d < len(s) else None
            if p is not None:
                shape[d] *= axis_size(mesh, p)
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        seen = set()
        for i in range(mesh.size):
            b = block(shape, s, mesh, i)
            key = tuple((x.start, x.stop) for x in b)
            if key not in seen:
                seen.add(key)
                out[b] = flats[i][k].to(dev)
        leaves.append(out)
    return tr.unflatten(treedef, leaves)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple leaf)."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for x in t:
                walk(x)
        else:
            out.append(tuple(t))

    walk(specs)
    return out
