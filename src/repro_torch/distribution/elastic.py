"""Elastic env-slot pool growth — port of ``repro.distribution.elastic``.

The engine allocates a *slot pool* of ``E`` env rows and carries an
``active: (E,) bool`` mask beside the state, so envs can attach and detach
between window batches with no change of shape. This module owns the one
operation that changes shapes: growing the pool when it fills.

Protocol (driven by ``runtime.system.PerceptaSystem.resize``):

1. :func:`next_pool_size` picks the new capacity (doubling, and a multiple
   of the device count).
2. :func:`grow_env_tree` pads every env-leading leaf of the state, decide
   carry and replay trees from ``old_e`` rows to the new capacity, taking
   the fresh rows from a template built at the new size (a template holds
   the init values: ``prev_ts = -1e30``, the norm min/max at +-inf), while
   leaves without an env axis (policy params, cursors, versions) pass
   through. Surviving rows are copied bit-exactly.
3. The caller rebuilds the pipeline at the new width.

:func:`reset_env_rows` is the attach/detach half: it rewrites single slot
rows from a fresh init template between batches. It writes new tensors
(``index_copy``, not ``index_copy_``): a tree's leaves may be shared with
a snapshot, a mirror or a batch's outputs, and none of them may change.

Trees are NamedTuples, tuples, lists and dicts of tensors (``None`` holds
no leaf), walked by ``train.tree``.
"""
from __future__ import annotations

import torch

from repro_torch.train import tree as tr


def next_pool_size(n_active: int, current_slots: int,
                   n_devices: int = 1) -> int:
    """Smallest doubled capacity holding ``n_active`` envs, rounded up to a
    multiple of ``n_devices``."""
    if n_active <= current_slots:
        return current_slots
    slots = max(1, current_slots)
    while slots < n_active:
        slots *= 2
    if n_devices > 1 and slots % n_devices:
        slots += n_devices - slots % n_devices
    return slots


def grow_env_tree(tree, template, old_e: int):
    """Pad the env-leading leaves of ``tree`` to the template's capacity.

    For each leaf pair ``(x, t)``: equal shapes pass ``x`` through
    unchanged; shapes that differ only in the leading dim, with ``x`` at
    ``old_e`` rows and ``t`` at more, give ``cat([x, t[old_e:]])``; any
    other mismatch raises. Works on a single tensor as on a tree."""
    def leaf(x, t):
        if x.shape == t.shape:
            return x
        if (x.dim() == t.dim() and x.dim() >= 1
                and x.shape[1:] == t.shape[1:] and x.shape[0] == old_e
                and t.shape[0] > old_e):
            return torch.cat([x, t[old_e:].to(x.device)], dim=0)
        raise ValueError(
            f"grow_env_tree: leaf shape {tuple(x.shape)} does not match "
            f"template {tuple(t.shape)} (expected equal, or env-dim growth "
            f"from {old_e})")

    return tr.map_(leaf, tree, template)


def reset_env_rows(tree, template, slots):
    """Rewrite the ``slots`` rows of the env-leading leaves of ``tree``
    from the template (same structure and shapes). A leaf takes part when
    its shape equals its template's and its leading dim is the template's
    env dim (the leading dim of the template's first leaf with one);
    other leaves pass through. Returns new tensors for the rewritten
    leaves; ``tree`` itself is left as it was."""
    slots = [int(s) for s in slots]
    if not slots:
        return tree
    env_dim = next((t.shape[0] for t in tr.leaves(template) if t.dim() >= 1),
                   None)

    def leaf(x, t):
        if x.dim() >= 1 and x.shape == t.shape and x.shape[0] == env_dim:
            idx = torch.as_tensor(slots, dtype=torch.int64, device=x.device)
            return x.index_copy(0, idx, t.to(x.device).index_select(0, idx))
        return x

    return tr.map_(leaf, tree, template)
