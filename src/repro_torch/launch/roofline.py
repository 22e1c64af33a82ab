"""Model FLOPs and the H100's peaks — the part of ``repro.launch.roofline``
that applies to the port.

:func:`model_flops` is the reference's MODEL_FLOPS count (6 N D for a
train step, 2 N D for a forward-only serving cell). The rest of the
reference module reads XLA's compiled HLO (cost analysis, collectives,
memory analysis), like ``launch/hlo_analysis.py``: not applicable to the
port, whose programs are PyTorch ops and hand-written kernels.

The peaks are one NVIDIA H100 SXM's published dense rates (the card's
data sheet, at its 700 W limit): a share of them is a reading, stated
with the card's name and power limit beside it.
"""
from __future__ import annotations

BF16_FLOPS = 989e12      # bfloat16 (and float16) tensor cores, dense
F32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 495e12      # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward-only serve cells).

    N excludes the input embedding table (a gather, not a matmul) but keeps
    the LM head; tied models count the shared table once (as the head).
    """
    n_active = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token


def flop_share(cfg, shape, seconds: float, peak: float = BF16_FLOPS) -> float:
    """:func:`model_flops` over ``seconds`` as a share of ``peak``."""
    return model_flops(cfg, shape) / seconds / peak
