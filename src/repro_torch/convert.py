"""Carry weights and state across from the reference package.

Everything arrives as numpy arrays (the reference's leaves converted with
``np.asarray``), so this module imports neither ``jax`` nor ``repro``:
  * :func:`policy_params_from_numpy` — a policy builder's params, for the
    port builders' ``params=``;
  * :func:`pipeline_state_from_numpy` — a ``PipelineState``;
  * :func:`replay_from_numpy` — a ``ReplayBuffer``.
Dtypes are kept as the reference has them: float32 values and int32
counters (``tick_index``, ``tick_idx``, ``version``, ``cursor``).
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


def _t(x, device):
    a = np.asarray(x)
    if a.dtype == np.float64:
        raise TypeError("float64 leaf: the reference's device leaves are "
                        "float32")
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
