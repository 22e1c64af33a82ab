"""Carry weights and state across from the reference package.

Everything arrives as numpy arrays (the reference's leaves converted with
``np.asarray``), so this module imports neither ``jax`` nor ``repro``:
  * :func:`policy_params_from_numpy` — a policy builder's params, for the
    port builders' ``params=``;
  * :func:`pipeline_state_from_numpy` — a ``PipelineState``;
  * :func:`replay_from_numpy` — a ``ReplayBuffer``;
  * :func:`decide_state_from_numpy` — the fused engine's ``DecideState``;
  * :func:`lm_params_from_numpy` / :func:`lm_cache_from_numpy` — an LM's
    param tree (for ``LM(params=)``) and its decode cache, with the
    reference's stacked pattern groups and ``tail`` layers split into the
    port's per-layer list.
Dtypes are kept as the reference has them: float32 or bfloat16 values,
int32 counters (``tick_index``, ``tick_idx``, ``version``, ``cursor``,
``lengths``, ``tick``) and bool flags (``valid``, ``have_prev``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import anomaly as an
from repro_torch.core import gapfill as gf
from repro_torch.core import normalize as nz
from repro_torch.core import replay as rp
from repro_torch.core.pipeline import PipelineState
from repro_torch.runtime.policies import POLICIES
from repro_torch.runtime.predictor import DecideState


def _t(x, device):
    a = np.asarray(x)
    if a.dtype == np.float64:
        raise TypeError("float64 leaf: the reference's device leaves are "
                        "float32")
    if a.dtype.name == "bfloat16":   # numpy holds it as ml_dtypes' type
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def policy_params_from_numpy(name: str, params, device="cpu") -> dict:
    """``{key: array}`` of a reference policy builder -> ``{key: tensor}``
    for the port builder of the same name (``params=``)."""
    if name not in POLICIES:
        raise ValueError(f"policy {name!r} is not ported yet")
    return {k: _t(v, device) for k, v in params.items()}


def pipeline_state_from_numpy(state, device="cpu") -> PipelineState:
    """A reference ``PipelineState`` with numpy leaves -> the port's."""
    g, a, n = state.gapfill, state.anomaly, state.norm
    return PipelineState(
        gapfill=gf.GapFillState(*(_t(x, device) for x in g)),
        anomaly=an.AnomalyState(*(_t(x, device) for x in a)),
        norm=nz.NormState(*(_t(x, device) for x in n)),
        prev_value=_t(state.prev_value, device),
        prev_ts=_t(state.prev_ts, device),
        tick_index=_t(np.asarray(state.tick_index, np.int32), device),
    )


def replay_from_numpy(buf, device="cpu") -> rp.ReplayBuffer:
    """A reference ``ReplayBuffer`` with numpy leaves -> the port's."""
    return rp.ReplayBuffer(*(_t(x, device) for x in buf))


def decide_state_from_numpy(dstate, device="cpu") -> DecideState:
    """A reference ``DecideState`` with numpy leaves -> the port's: prev
    obs and actions, ``have_prev``, ``tick``, the replay ring, the policy
    params, the versions and the recurrent model carry (a dict of per-env
    leaves, or None). The elastic ``active``/``prev_ok`` leaves are not
    ported and must be None."""
    if getattr(dstate, "active", None) is not None \
            or getattr(dstate, "prev_ok", None) is not None:
        raise ValueError("elastic DecideState leaves are not ported yet: "
                         "ROADMAP.md queue 1 item 10")
    leaf = lambda x: _t(x, device)
    return DecideState(
        prev_obs=leaf(dstate.prev_obs),
        prev_actions=leaf(dstate.prev_actions),
        have_prev=leaf(np.asarray(dstate.have_prev, np.bool_)),
        tick=leaf(np.asarray(dstate.tick, np.int32)),
        replay=replay_from_numpy(dstate.replay, device),
        policy=_map(dict(dstate.policy), leaf),
        version=leaf(np.asarray(dstate.version, np.int32)),
        prev_version=leaf(np.asarray(dstate.prev_version, np.int32)),
        carry=None if dstate.carry is None else _map(dict(dstate.carry),
                                                     leaf),
    )


def _per_layer(tree, cfg, leaf):
    """The reference's {"groups": stacked slots, "tail": tail slots} ->
    a list in model order (layer g * len(pattern) + i is group g's slot i;
    the tail follows)."""
    n_pat = len(cfg.layer_pattern)
    layers = []
    for g in range(cfg.n_groups):
        for i in range(n_pat):
            slot = tree["groups"][f"slot{i}"]
            layers.append(_map(slot, lambda x: leaf(np.asarray(x)[g])))
    n_tail = cfg.n_layers - cfg.n_groups * n_pat
    for i in range(n_tail):
        layers.append(_map(tree["tail"][f"tail{i}"], leaf))
    return layers


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(params, cfg, device="cpu") -> dict:
    """A reference ``LM``'s params (numpy leaves) -> the port layout
    ``{"embed": {...}, "layers": [{"attn": {...}, "ffn": {...}}, ...]}``
    for ``repro_torch.models.LM(cfg, params=...)``."""
    leaf = lambda x: _t(x, device)
    return {"embed": _map(params["embed"], leaf),
            "layers": _per_layer(params, cfg, leaf)}


def lm_cache_from_numpy(cache, cfg, device="cpu") -> dict:
    """A reference decode cache (numpy leaves) -> the port's
    ``{"lengths": (B,) int32, "layers": [{"k", "v"}, ...]}``."""
    leaf = lambda x: _t(x, device)
    return {"lengths": _t(np.asarray(cache["lengths"], np.int32), device),
            "layers": _per_layer(cache, cfg, leaf)}
