"""StreamFrame — the batched unit of data flowing through Percepta on device.

Tensor dimensions, as in ``repro.core.frame``:
  E = environments, S = streams, M = raw samples per window (padded + a
  validity mask), T = tick grid after harmonization.

A RawWindow holds what the Accumulator collected during one Manager window;
a TickFrame is the harmonized/gap-filled/normalized result the Predictor
consumes. Both are NamedTuples of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RawWindow(NamedTuple):
    """Raw samples collected in one window. Shapes (E, S, M)."""
    values: torch.Tensor      # float32
    # float32 seconds in the WINDOW's frame (rebased in float64 on the host
    # before the cast); window_start must share the frame
    timestamps: torch.Tensor
    valid: torch.Tensor       # bool — padding / lost samples are False

    @property
    def n_envs(self):
        return self.values.shape[0]

    @property
    def n_streams(self):
        return self.values.shape[1]

    @property
    def max_samples(self):
        return self.values.shape[2]


class TickFrame(NamedTuple):
    """Harmonized per-tick data. Shapes (E, S, T)."""
    values: torch.Tensor
    observed: torch.Tensor    # bool — True where a real sample backed the tick
    filled: torch.Tensor      # bool — True where gap-filling synthesized it
    anomalous: torch.Tensor   # bool — True where anomaly handling replaced it


class FeatureFrame(NamedTuple):
    """Model-facing features after aggregation. Shapes (E, F)."""
    features: torch.Tensor    # normalized (what the model consumes)
    raw: torch.Tensor         # engineering units (what rewards are computed on)
    quality: torch.Tensor     # (E,) fraction of feature inputs observed
    tick_time: torch.Tensor   # (E,) timestamp of the tick


def make_raw_window(values, timestamps, valid=None, *,
                    device="cpu") -> RawWindow:
    """Build a RawWindow on ``device`` from host arrays, always copied: the
    host staging buffers are reused between batches, and
    ``torch.from_numpy`` alone would alias them on the CPU."""
    to = lambda x, dt: torch.from_numpy(np.array(x, dtype=dt)).to(device)
    v, t = to(values, np.float32), to(timestamps, np.float32)
    m = (torch.ones(v.shape, dtype=torch.bool, device=v.device)
         if valid is None else to(valid, np.bool_))
    return RawWindow(v, t, m)


def empty_tick_frame(E, S, T, device="cpu") -> TickFrame:
    z = torch.zeros((E, S, T), dtype=torch.float32, device=device)
    f = torch.zeros((E, S, T), dtype=torch.bool, device=device)
    return TickFrame(z, f, f, f)
