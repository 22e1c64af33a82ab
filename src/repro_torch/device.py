"""Device resolution for the port's entry points.

Every entry point (``PerceptaSystem``, ``Predictor``, ``PerceptaPipeline``,
``build_policy``) takes ``device=None``, which means the CUDA card. The CPU
is reached only by asking for it (``device="cpu"``), as the tests do; there
is no silent fallback, because a run that quietly lands on the CPU would
report CPU numbers under the card's name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device=\"cpu\" to run on the CPU")
    return dev
