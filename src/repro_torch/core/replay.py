"""Experience storage for retraining — port of ``repro.core.replay``.

A fixed-capacity ring over (obs, action, reward, next_obs, tick_idx,
policy_version, valid), batched across environments and living on the
device. Unlike the reference, whose buffers are immutable, :func:`add`,
:func:`add_many` and :func:`add_batch` write the ring IN PLACE (cursor
included) and return the same buffer: at
E=256 and capacity 4096 a copy of the ring per write would move tens of MB
for a few KB of new rows. The cursor stays a device int32 scalar, so a
write needs no host round trip.

Long-horizon time rule: the per-transition time is the EXACT int32 tick
index, never a float32 absolute timestamp; the float64 wall time of each
tick lives host-side and is re-attached by :func:`export_for_training`.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch


class ReplayBuffer(NamedTuple):
    obs: torch.Tensor        # (E, C, F)
    actions: torch.Tensor    # (E, C, A)
    rewards: torch.Tensor    # (E, C)
    next_obs: torch.Tensor   # (E, C, F)
    tick_idx: torch.Tensor   # (E, C) int32 — exact predictor tick index
    version: torch.Tensor    # (E, C) int32 — policy_version of the action
    valid: torch.Tensor      # (E, C) bool — cell liveness
    cursor: torch.Tensor     # () int32 — total ticks written

    @property
    def capacity(self):
        return self.obs.shape[1]

    def size(self):
        return torch.clamp(self.cursor, max=self.capacity)


def init(E, capacity, n_features, n_actions, device="cpu") -> ReplayBuffer:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return ReplayBuffer(
        obs=torch.zeros((E, capacity, n_features), **f32),
        actions=torch.zeros((E, capacity, n_actions), **f32),
        rewards=torch.zeros((E, capacity), **f32),
        next_obs=torch.zeros((E, capacity, n_features), **f32),
        tick_idx=torch.zeros((E, capacity), **i32),
        version=torch.zeros((E, capacity), **i32),
        valid=torch.zeros((E, capacity), dtype=torch.bool, device=device),
        cursor=torch.zeros((), **i32),
    )


def add(buf: ReplayBuffer, obs, actions, rewards, next_obs,
        tick_idx, version=0) -> ReplayBuffer:
    """Write one tick for every env at the ring position, in place.

    ``tick_idx`` and ``version`` are scalars or (E,), stored as int32.
    Returns ``buf`` (the same tensors, updated)."""
    E = buf.obs.shape[0]
    slot = torch.remainder(buf.cursor, buf.capacity).to(torch.int64)
    slot = slot.reshape(1)

    def put(b, x):
        x = torch.as_tensor(x, device=b.device).to(b.dtype)
        x = x.expand((E,) + b.shape[2:])
        b.index_copy_(1, slot, x.unsqueeze(1))

    put(buf.obs, obs)
    put(buf.actions, actions)
    put(buf.rewards, rewards)
    put(buf.next_obs, next_obs)
    put(buf.tick_idx, tick_idx)
    put(buf.version, version)
    put(buf.valid, True)
    buf.cursor.add_(1)
    return buf


def add_many(buf: ReplayBuffer, obs, actions, rewards, next_obs, tick_idx,
             mask=None, version=None) -> ReplayBuffer:
    """Write K stacked ticks (leading K axis on every argument; ``tick_idx``
    is (K,)) as K sequential :func:`add` calls, so write order, cursor
    advance and wraparound — even K > capacity — are exactly those of the
    sequential writes. ``mask`` (K,) bools, known on the host, skips rows
    without advancing the cursor."""
    K = obs.shape[0]
    mask = [True] * K if mask is None else [bool(m) for m in mask]
    for k in range(K):
        if mask[k]:
            add(buf, obs[k], actions[k], rewards[k], next_obs[k],
                tick_idx[k], 0 if version is None else version[k])
    return buf


def add_batch(buf: ReplayBuffer, obs, actions, rewards, next_obs, tick_idx,
              mask=None, version=None, env_mask=None) -> ReplayBuffer:
    """Write K stacked ticks as one gather-select-scatter per leaf, in
    place and with no host sync (``mask`` and ``version`` may be device
    tensors; ``tick_idx``, ``mask`` and ``version`` are (K,)).

    Final contents and cursor are those of K sequential guarded
    :func:`add` calls (:func:`add_many`), bit for bit, masked rows and
    K > capacity included. Torch has no ``mode="drop"`` scatter, and a
    scatter with repeated indices has no defined winner on CUDA, so the
    write goes the other way round: the last ``L = min(K, capacity)``
    ring positions of the batch, ``total - L .. total - 1``, are L
    distinct slots; each one written this batch (position >= cursor)
    takes the masked row that lands there (``searchsorted`` over the
    running count of masked rows), the others keep their old contents.
    Every touched slot is written exactly once, and only L slots move.
    ``env_mask`` (elastic env pools) is refused."""
    if env_mask is not None:
        raise ValueError("add_batch(env_mask=...): elastic env pools are "
                         "not ported yet: ROADMAP.md queue 1 item 10")
    K = obs.shape[0]
    E, C = buf.obs.shape[:2]
    dev = buf.obs.device
    i64 = dict(dtype=torch.int64, device=dev)
    mask = (torch.ones((K,), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).to(torch.bool))
    version = (torch.zeros((K,), **i64) if version is None
               else torch.as_tensor(version, device=dev))
    written = mask.to(torch.int64).cumsum(0)     # masked rows up to row j
    cursor = buf.cursor.to(torch.int64)
    total = cursor + written[-1]
    L = min(K, C)
    pos = total - L + torch.arange(L, **i64)     # the batch's last L writes
    hit = pos >= cursor
    src = torch.searchsorted(written, pos - cursor + 1).clamp(max=K - 1)
    slot = torch.remainder(pos, C)

    def put(b, x):
        x = torch.as_tensor(x, device=dev).to(b.dtype)
        x = x.reshape((K,) + x.shape[1:] + (1,) * (b.dim() - x.dim()))
        new = x.expand((K, E) + b.shape[2:])[src].transpose(0, 1)
        keep = hit.reshape((1, L) + (1,) * (b.dim() - 2))
        b.index_copy_(1, slot, torch.where(keep, new, b.index_select(1,
                                                                     slot)))

    put(buf.obs, obs)
    put(buf.actions, actions)
    put(buf.rewards, rewards)
    put(buf.next_obs, next_obs)
    put(buf.tick_idx, tick_idx)
    put(buf.version, version)
    put(buf.valid, torch.ones((K,), dtype=torch.bool, device=dev))
    buf.cursor.copy_(total)
    return buf


def anonymize_env_ids(env_ids, salt: str) -> list:
    """Salted-hash pseudonyms for export (host-side)."""
    out = []
    for e in env_ids:
        h = hashlib.sha256((salt + "::" + str(e)).encode()).hexdigest()[:16]
        out.append(f"env-{h}")
    return out


def chronological_order(buf: ReplayBuffer):
    """Slot permutation putting the ring's live rows in write order."""
    c = int(buf.cursor)
    C = buf.capacity
    if c > C:
        head = c % C
        return np.concatenate([np.arange(head, C), np.arange(head)])
    return np.arange(c)


def export_for_training(buf: ReplayBuffer, env_ids, salt: str,
                        slot_times=None) -> dict:
    """Materialize an anonymized dataset dict (host numpy), rows rolled to
    chronological order even after the ring has wrapped. ``slot_times`` is
    the optional (capacity,) float64 host mirror of absolute tick times;
    without it ``times`` is the float64 value of the stored tick index."""
    order = chronological_order(buf)
    take = lambda x: x.cpu().numpy()[:, order]
    tick_idx = take(buf.tick_idx)
    if slot_times is not None:
        times = np.asarray(slot_times, np.float64)[order]
        times = np.broadcast_to(times[None, :], tick_idx.shape).copy()
    else:
        times = tick_idx.astype(np.float64)
    return {
        "env_ids": anonymize_env_ids(env_ids, salt),
        "obs": take(buf.obs),
        "actions": take(buf.actions),
        "rewards": take(buf.rewards),
        "next_obs": take(buf.next_obs),
        "tick_idx": tick_idx,
        "version": take(buf.version),
        "valid": take(buf.valid),
        "times": times,
    }
