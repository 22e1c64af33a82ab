"""Declarative parameter trees — port of ``repro.models.param``.

Models declare parameters as nested dicts of :class:`ParamDef` carrying the
shape, torch dtype, initializer and the logical dimension names of every
axis (kept for parity with the reference; the port does not shard yet).
``init`` draws every leaf from one ``torch.Generator``, in the order of
the flattened tree. Initializers: ``normal`` (times ``scale``), ``zeros``
and ``uniform`` on [``low``, ``high``) (the reference's ``custom`` uniform
draws: RG-LRU ``lam``, RWKV ``mu``, ``cm_mu`` and ``decay_base``).
JAX's threefry draws cannot be reproduced in torch, so tests carry the
reference's weights across with ``repro_torch.convert.lm_params_from_numpy``
instead.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    dims: tuple                 # logical dim name per axis, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | uniform
    scale: float = 0.02
    low: float = 0.0            # uniform's range [low, high)
    high: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} differ "
                             "in rank")

    def materialize(self, generator: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "uniform":
            x = torch.rand(self.shape, generator=generator, device=device,
                           dtype=torch.float32)
            return (x * (self.high - self.low) + self.low).to(self.dtype)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        x = torch.randn(self.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * self.scale).to(self.dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def map_defs(fn, tree):
    """Apply ``fn`` to every ParamDef of a nested dict/list tree."""
    if is_def(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_defs(fn, v) for v in tree)
    raise TypeError(f"not a param tree node: {type(tree)}")


def leaves(tree) -> list:
    out = []
    map_defs(out.append, tree)
    return out


def init(tree, generator: torch.Generator, device):
    """Materialize every leaf, drawing from ``generator`` in tree order."""
    return map_defs(lambda d: d.materialize(generator, device), tree)


def count(tree) -> int:
    return sum(int(np.prod(d.shape)) for d in leaves(tree))


def bytes_of(tree) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize for d in leaves(tree))
