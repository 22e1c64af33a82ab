"""Plain PyTorch version of the LOCF kernel (twin of ``locf_ref``)."""
from __future__ import annotations

import torch


def locf_ref(values, observed, init_value, init_has):
    """Carry the latest observation along the tick axis.

    values/observed: (R, T) float32/bool; init_value/init_has: (R,) carry-in
    from the previous window. Returns (filled (R, T), has (R, T)). Pure
    selection: the index of the latest observation at or before each tick
    comes from a running max, and the value is gathered at that index, so
    where no observation exists the carry-in value comes back with
    has=False (as the associative scan of the reference returns it).
    """
    v = torch.cat([init_value[:, None], values], dim=1)
    o = torch.cat([init_has[:, None], observed], dim=1)
    j = torch.arange(v.shape[1], device=v.device)
    latest = torch.where(o, j, -1).cummax(dim=1).values
    filled = v.gather(1, latest.clamp(min=0))
    return filled[:, 1:], (latest >= 0)[:, 1:]
