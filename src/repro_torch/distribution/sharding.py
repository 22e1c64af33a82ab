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
decide carry's ``policy`` subtree whatever its ranks. The model-sharding
half of the reference module (``param_rules``, ``resolve``, ...) belongs
to the training stack and is not ported here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

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
