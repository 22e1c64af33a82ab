"""Plain PyTorch version of the RG-LRU scan kernel (twin of
``rglru_scan_ref``)."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t. a, b: (B, T, W) float32; h0: (B, W).

    Returns (hs (B, T, W), h_last (B, W)). A plain sequential loop: each
    step is one rounded multiply and one rounded add, never an FMA.
    """
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
