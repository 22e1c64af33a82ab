"""Model meshes — port of ``repro.launch.mesh``.

A :class:`ModelMesh` names axes (``data``, ``model``, and ``pod`` for the
multi-pod shape) over an array of ``torch.device``. A device may repeat:
N *logical* shards on one card run exactly the code of N real ones, as an
``EnvMesh`` does for envs. Shard ``i`` is the i-th coordinate in
row-major order; a sharded tree is a tuple of per-shard trees in that
order (``distribution.sharding.place_tree``).

    Single pod : (data=16, model=16)            = 256 devices
    Multi-pod  : (pod=2, data=16, model=16)     = 512 devices
    Smoke      : (data=1, model=1) over one device

Devices come from ``distribution.sharding.visible_devices``, the one place
that lists them; replace it for logical shards::

    sharding.visible_devices = lambda device: [torch.device("cpu")] * 8
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distribution import sharding


class ModelMesh:
    """Named axes over a ``devices`` array of their shape."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self._coords = list(np.ndindex(arr.shape))

    def __repr__(self):
        return (f"ModelMesh({self.shape}, physical={self.physical})")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def physical(self) -> int:
        """The number of distinct devices."""
        return len(set(self.devices.flat))

    def device(self, i: int) -> torch.device:
        return self.devices[self._coords[i]]

    def axis_index(self, i: int, axes) -> int:
        """Shard ``i``'s row-major index over ``axes`` (in the order
        given; absent axes are skipped): the block it holds of a dim split
        over them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        j = 0
        for a in axes:
            if a in self.shape:
                k = self.axis_names.index(a)
                j = j * self.shape[a] + self._coords[i][k]
        return j

    def groups(self, axes) -> list:
        """The shards that differ only along ``axes``: a list of groups,
        each a list of shard indices in :meth:`axis_index` order (the
        order a collective over ``axes`` combines them in)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a in self.shape)
        keep = [k for k, a in enumerate(self.axis_names) if a not in axes]
        out: dict = {}
        for i, c in enumerate(self._coords):
            out.setdefault(tuple(c[k] for k in keep), []).append(i)
        return [sorted(g, key=lambda i: self.axis_index(i, axes))
                for g in out.values()]


def make_mesh(shape, axes=("data", "model"), devices=None,
              device=None) -> ModelMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default ``sharding.visible_devices(device)``, ``device=None`` meaning
    the card). Raises ``RuntimeError`` when there are fewer."""
    n = math.prod(shape)
    if devices is None:
        devices = sharding.visible_devices(resolve_device(device))
    devices = list(devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} devices, have {len(devices)}; "
            "logical shards: replace distribution.sharding.visible_devices "
            "to name a device more than once")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return ModelMesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ModelMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"),
                    device=None) -> ModelMesh:
    """A (1, 1) mesh over the first visible device."""
    return make_mesh(shape, axes, device=device)
