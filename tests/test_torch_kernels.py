"""The port's three kernels against the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the JAX oracle (``ref.py``) and, for locf and window_agg, the
Pallas kernel in interpret mode. rglru_scan is held against its oracle
only: its Pallas path is red under the installed JAX. The CUDA kernels
themselves are held against their plain versions on the card by
``test_torch_card.py``.

Tolerances: bool outputs, counts, min/max/last and LOCF values where
``has`` is True are pure selection or exact integer counts and must match
exactly; float sums (window mean/var/sum, the recurrence) use rtol = atol =
1e-5, because XLA and torch add in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.locf.ops import locf as jax_locf
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.kernels.window_agg.ops import window_agg as jax_window_agg
from repro_torch.kernels.locf import ops as locf_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.window_agg import ops as wagg_ops

TOL = dict(rtol=1e-5, atol=1e-5)
T_ = lambda x: torch.from_numpy(np.array(x))  # a writable private copy
# E*S = 9 and 15 rows: not multiples of the TPU's 8-row blocks
SHAPES = [(3, 3, 8), (5, 3, 16)]


def _locf_inputs(rng, E, S, T, empty_rows=True):
    v = rng.normal(0, 1, (E, S, T)).astype(np.float32)
    o = rng.rand(E, S, T) > 0.6
    if empty_rows:
        o[0, 0] = False   # an all-unobserved row with a carry-in
        o[-1, -1] = False  # ...and one without
    iv = rng.normal(0, 1, (E, S)).astype(np.float32)
    ih = rng.rand(E, S) > 0.5
    ih[0, 0], ih[-1, -1] = True, False
    return v, o, iv, ih


@pytest.mark.parametrize("E,S,T", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_locf_matches_jax(E, S, T, use_pallas, rng):
    v, o, iv, ih = _locf_inputs(rng, E, S, T)
    want_v, want_h = map(np.asarray,
                         jax_locf(v, o, iv, ih, use_pallas=use_pallas))
    got_v, got_h = locf_ops.locf(T_(v), T_(o), T_(iv), T_(ih))
    got_v, got_h = got_v.numpy(), got_h.numpy()
    assert (got_h == want_h).all()
    assert not got_h[-1, -1].any() and got_h[0, 0].all()
    assert np.array_equal(got_v[got_h], want_v[want_h])


def test_locf_carry_from_warmed_gapfill_state(rng):
    """Carry-in from a warmed gap-fill state: the port op equals the JAX
    gap-fill stage it replaces (same carry test ``last_ts > -1e29``)."""
    from repro.core import gapfill as jgf
    E, S, T = 3, 3, 8
    v, o, _, _ = _locf_inputs(rng, E, S, T)
    ticks = jnp.broadcast_to(jnp.arange(T, dtype=jnp.float32) * 60.0, (E, T))
    _, _, st = jgf.gap_fill(jnp.asarray(v), jnp.asarray(o), jgf.init_state(
        E, S), ticks, "locf")
    v2, o2, _, _ = _locf_inputs(rng, E, S, T)
    want_v, want_h = map(np.asarray, jgf.locf(jnp.asarray(v2),
                                              jnp.asarray(o2), st))
    got_v, got_h = locf_ops.locf(
        T_(v2), T_(o2), T_(np.asarray(st.last_value)),
        T_(np.asarray(st.last_ts) > -1e29))
    assert (got_h.numpy() == want_h).all()
    assert np.array_equal(got_v.numpy()[want_h], want_v[want_h])


def _wagg_inputs(rng, E, S, T):
    v = rng.normal(5, 2, (E, S, T)).astype(np.float32)
    m = rng.rand(E, S, T) > 0.3
    m[0, 0] = False                      # an empty window
    mu = rng.normal(5, 1, (E, S)).astype(np.float32)
    var = (np.abs(rng.normal(1, 0.3, (E, S))) + 0.05).astype(np.float32)
    return v, m, mu, var


@pytest.mark.parametrize("E,S,T", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_window_agg_matches_jax(E, S, T, use_pallas, rng):
    v, m, mu, var = _wagg_inputs(rng, E, S, T)
    want_s, want_sp = map(np.asarray, jax_window_agg(
        v, m, mu, var, k_sigma=1.5, use_pallas=use_pallas))
    got_s, got_sp = wagg_ops.window_agg(T_(v), T_(m), T_(mu), T_(var),
                                        k_sigma=1.5)
    got_s, got_sp = got_s.numpy(), got_sp.numpy()
    assert (got_sp == want_sp).all() and want_sp.any()
    exact = [2, 3, 4, 5, 7]              # min, max, last, count, n_spikes
    assert np.array_equal(got_s[..., exact], want_s[..., exact])
    assert_allclose(got_s[..., [0, 1, 6]], want_s[..., [0, 1, 6]], **TOL)
    assert (got_s[0, 0] == 0).all()


@pytest.mark.parametrize("B,T,W", [(4, 1, 16), (3, 12, 16), (2, 5, 7)])
def test_rglru_scan_matches_jax_oracle(B, T, W, rng):
    a = rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32)
    b = rng.normal(0, 1, (B, T, W)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, W)).astype(np.float32)
    want_hs, want_h = map(np.asarray,
                          jax_rglru_scan(a, b, h0, use_pallas=False))
    got_hs, got_h = rglru_ops.rglru_scan(T_(a), T_(b), T_(h0))
    assert_allclose(got_hs.numpy(), want_hs, **TOL)
    assert_allclose(got_h.numpy(), want_h, **TOL)
    assert torch.equal(got_hs[:, -1], got_h)


def test_cpu_path_counts_no_launch(rng):
    before = (locf_ops.LAUNCHES, wagg_ops.LAUNCHES, rglru_ops.LAUNCHES)
    v, o, iv, ih = _locf_inputs(rng, 2, 2, 4)
    locf_ops.locf(T_(v), T_(o), T_(iv), T_(ih))
    v, m, mu, var = _wagg_inputs(rng, 2, 2, 4)
    wagg_ops.window_agg(T_(v), T_(m), T_(mu), T_(var))
    a = torch.ones((2, 1, 3))
    rglru_ops.rglru_scan(a, a, torch.zeros((2, 3)))
    assert (locf_ops.LAUNCHES, wagg_ops.LAUNCHES,
            rglru_ops.LAUNCHES) == before
