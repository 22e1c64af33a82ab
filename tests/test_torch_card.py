"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no card is present (the kernels
have no CPU mode; their plain versions are held against the JAX package by
``test_torch_kernels.py``). This file imports neither ``jax`` nor
``repro``, so it runs on a machine with the card and PyTorch alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_card.py``.

Tolerances: exact for selection (LOCF, min/max/last), counts, masks and
the recurrence (the kernel writes no FMA, the plain version has none);
rtol = atol = 1e-5 for window mean/var/sum, which add in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.locf.ref import locf_ref
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.window_agg import ops as wagg_ops
from repro_torch.kernels.window_agg.ref import window_agg_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (test_torch_kernels.py holds their plain versions)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(card, rng):
    """Each CUDA kernel against its plain version on the same card tensors,
    with a launch counted per call."""
    C = lambda x: torch.from_numpy(np.array(x)).to(card)
    before = (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES)
    v = rng.normal(0, 1, (64, 8, 64)).astype(np.float32)
    o = rng.rand(64, 8, 64) > 0.6
    o[0, 0] = False
    iv = rng.normal(0, 1, (64, 8)).astype(np.float32)
    ih = rng.rand(64, 8) > 0.5
    out, has = locf_ops.locf(C(v), C(o), C(iv), C(ih))
    ref_v, ref_h = locf_ref(C(v).reshape(512, 64), C(o).reshape(512, 64),
                            C(iv).reshape(512), C(ih).reshape(512))
    assert torch.equal(has.reshape(512, 64), ref_h)
    assert torch.equal(out.reshape(512, 64)[ref_h], ref_v[ref_h])

    v = rng.normal(5, 2, (64, 8, 64)).astype(np.float32)
    m = rng.rand(64, 8, 64) > 0.3
    m[0, 0] = False
    mu = rng.normal(5, 1, (64, 8)).astype(np.float32)
    var = (np.abs(rng.normal(1, 0.3, (64, 8))) + 0.05).astype(np.float32)
    stats, spikes = wagg_ops.window_agg(C(v), C(m), C(mu), C(var))
    ref_s, ref_sp = window_agg_ref(C(v).reshape(512, 64),
                                   C(m).reshape(512, 64), C(mu).reshape(512),
                                   C(var).reshape(512), 6.0)
    stats = stats.reshape(512, 8)
    assert torch.equal(spikes.reshape(512, 64), ref_sp)
    assert torch.equal(stats[:, [2, 3, 4, 5, 7]], ref_s[:, [2, 3, 4, 5, 7]])
    torch.testing.assert_close(stats[:, [0, 1, 6]], ref_s[:, [0, 1, 6]],
                               rtol=1e-5, atol=1e-5)

    a = C(rng.uniform(0.5, 1.0, (64, 33, 48)).astype(np.float32))
    b = C(rng.normal(0, 1, (64, 33, 48)).astype(np.float32))
    h0 = C(rng.normal(0, 1, (64, 48)).astype(np.float32))
    hs, h = rglru_ops.rglru_scan(a, b, h0)
    ref_hs, ref_h = rglru_scan_ref(a, b, h0)
    assert torch.equal(hs, ref_hs) and torch.equal(h, ref_h)
    assert (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES) == \
        tuple(n + 1 for n in before)
