"""Carry weights and state across from the reference package.

Everything arrives as numpy arrays (the reference's leaves converted with
``np.asarray``), so this module imports neither ``jax`` nor ``repro``:
  * :func:`policy_params_from_numpy` — a policy builder's params, for the
    port builders' ``params=``;
  * :func:`pipeline_state_from_numpy` — a ``PipelineState``;
  * :func:`replay_from_numpy` — a ``ReplayBuffer``;
  * :func:`decide_state_from_numpy` — the fused engine's ``DecideState``,
    and :func:`decide_state_on_mesh` — the same placed on an env mesh;
  * :func:`train_state_from_numpy` — the online trainer's state (critic
    and the joint optimizer state);
  * :func:`lm_params_from_numpy` / :func:`lm_cache_from_numpy` — an LM's
    param tree (for ``LM(params=)``) and its decode cache, with the
    reference's stacked pattern groups and ``tail`` layers split into the
    port's per-layer list;
  * :func:`lm_train_state_from_numpy` — an LM train step's AdamW state
    (``m``, ``v``, ``step``), so that both packages can take a step from
    the same state. The port's LM checkpoints (``train.loop``) keep the
    port's per-layer layout and do not restore into the reference, whose
    layers are stacked; the online trainer's checkpoints do.
Dtypes are kept as the reference has them: float32, bfloat16 or float16
values (a float16 model's weights and caches cross as they are),
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
from repro_torch.distribution import sharding as sh
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
        raise ValueError(f"unknown policy {name!r} "
                         f"(registered: {sorted(POLICIES)})")
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
    params, the versions, the recurrent model carry (a dict of per-env
    leaves, or None) and the elastic ``active``/``prev_ok`` masks ((E,)
    bool, or None for a dense carry)."""
    leaf = lambda x: _t(x, device)
    mask = lambda x: None if x is None else leaf(np.asarray(x, np.bool_))
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
        active=mask(getattr(dstate, "active", None)),
        prev_ok=mask(getattr(dstate, "prev_ok", None)),
    )


def decide_state_on_mesh(dstate, mesh, device="cpu") -> tuple:
    """A reference ``DecideState`` (numpy leaves; dense or elastic) as the
    per-shard carries of ``mesh``: :func:`decide_state_from_numpy`, then
    ``sharding.place_env_tree`` with ``decide_specs`` (policy params
    replicated, the rest split by rank)."""
    d = decide_state_from_numpy(dstate, device)
    return sh.place_env_tree(d, 0, mesh, sh.decide_specs(d, 0))


def train_state_from_numpy(tstate, device="cpu") -> dict:
    """A reference ``OnlineTrainer.train_state`` with numpy leaves ->
    the port's: ``{"critic": {"qw", "qb"}, "opt": {"m": {"critic",
    "policy"}, "v": {...}, "step": int32}}``."""
    leaf = lambda x: _t(x, device)
    opt = tstate["opt"]
    return {"critic": _map(dict(tstate["critic"]), leaf),
            "opt": {"m": _map(dict(opt["m"]), leaf),
                    "v": _map(dict(opt["v"]), leaf),
                    "step": leaf(np.asarray(opt["step"], np.int32))}}


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
    ``{"embed": {...}, "layers": [layer, ...]}`` for
    ``repro_torch.models.LM(cfg, params=...)``, a layer being ``{"attn",
    "ffn"}``, ``{"rglru", "ffn"}`` or ``{"rwkv"}`` by its kind (``ffn``
    the dense MLP or the MoE FFN), in model order whatever the pattern."""
    leaf = lambda x: _t(x, device)
    return {"embed": _map(params["embed"], leaf),
            "layers": _per_layer(params, cfg, leaf)}


def lm_cache_from_numpy(cache, cfg, device="cpu") -> dict:
    """A reference decode cache (numpy leaves) -> the port's
    ``{"lengths": (B,) int32, "layers": [layer, ...]}``, a layer being
    ``{"k", "v"}``, ``{"conv", "h"}`` (RG-LRU) or ``{"shift", "wkv",
    "cm_shift"}`` (RWKV) by its kind."""
    leaf = lambda x: _t(x, device)
    return {"lengths": _t(np.asarray(cache["lengths"], np.int32), device),
            "layers": _per_layer(cache, cfg, leaf)}


def lm_train_state_from_numpy(opt_state, cfg, device="cpu") -> dict:
    """A reference LM train step's optimizer state (numpy leaves: ``m``
    and ``v`` float32 over the params' tree, ``step`` int32) -> the port's
    ``{"m", "v", "step"}`` over the ``LM.params`` layout, for
    ``launch.steps.build_train_step``'s step."""
    return {"m": lm_params_from_numpy(opt_state["m"], cfg, device),
            "v": lm_params_from_numpy(opt_state["v"], cfg, device),
            "step": _t(np.asarray(opt_state["step"], np.int32), device)}
