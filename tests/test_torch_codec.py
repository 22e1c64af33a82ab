"""The port's Encoder/Decoder (``core.codec``) against ``repro.core.codec``.

Both packages get the same seeded numpy inputs: running norm statistics
from one window of samples (the JAX ``NormState`` moved across leaf by
leaf), then features, decisions and tokens. Tolerance: 1e-5 absolute and
relative on float outputs (both sides compute the same float32 ops, in
the same order, up to XLA's fusion; the observed gap is ~1e-7), tokens
exactly. ``EmbeddingCodec``'s projection is the reference's draw from its
JAX key, fed to the port as a numpy array (torch cannot reproduce the
draw). The round trip of ``TokenCodec`` is held within half a bin in
z-space, as ``tests/test_property.py`` holds the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import codec as jcd
from repro.core import normalize as jnz
from repro_torch.core import codec as pcd
from repro_torch.core import normalize as pnz

TOL = dict(rtol=1e-5, atol=1e-5)
E, NF = 4, 6


def _states(seed):
    rng = np.random.RandomState(seed)
    v = rng.normal(10, 4, (E, NF, 32)).astype(np.float32)
    ok = rng.rand(*v.shape) < 0.9
    js = jnz.update(jnz.init_state(E, NF), jnp.asarray(v), jnp.asarray(ok))
    ps = pnz.NormState(*(torch.from_numpy(np.array(x)) for x in js))
    feats = rng.normal(10, 6, (E, NF)).astype(np.float32)
    return rng, js, ps, feats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vector_codec_matches_jax(seed):
    rng, js, ps, feats = _states(seed)
    jc, pc = jcd.VectorCodec(NF, clip=2.0), pcd.VectorCodec(NF, clip=2.0)
    want = np.asarray(jc.encode(js, jnp.asarray(feats)))
    got = pc.encode(ps, torch.from_numpy(feats)).numpy()
    assert_allclose(got, want, **TOL)
    assert np.abs(got).max() <= 2.0
    out = rng.normal(0, 2, (E, NF)).astype(np.float32)
    want = np.asarray(jc.decode(js, jnp.asarray(out), 5.0, 15.0))
    got = pc.decode(ps, torch.from_numpy(out), 5.0, 15.0).numpy()
    assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_codec_matches_jax_and_roundtrips_within_a_bin(seed):
    rng, js, ps, feats = _states(seed)
    jc, pc = jcd.TokenCodec(NF), pcd.TokenCodec(NF)
    assert pc.vocab_needed == jc.vocab_needed
    want = np.asarray(jc.encode(js, jnp.asarray(feats)))
    toks = pc.encode(ps, torch.from_numpy(feats))
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), want)
    assert (toks >= pc.offset).all() and (toks < pc.vocab_needed).all()
    back = pc.decode(ps, toks, -1e9, 1e9)
    assert_allclose(back.numpy(), np.asarray(
        jc.decode(js, jnp.asarray(want), -1e9, 1e9)), **TOL)
    half_bin_z = (2 * pc.clip / pc.bins) / 2
    sig = pnz.sigma(ps).numpy()
    z = pnz.znorm(ps, torch.from_numpy(feats)[..., None])[..., 0].numpy()
    z_err = np.abs(back.numpy() - feats) / np.maximum(sig, 1e-6)
    inside = np.abs(z) <= pc.clip
    assert inside.any()
    assert (z_err[inside] <= half_bin_z + 1e-3).all()


def test_embedding_codec_matches_jax_and_is_input_only():
    rng, js, ps, feats = _states(0)
    jc = jcd.EmbeddingCodec(NF, d_model=16, n_frames=3, seed=5)
    proj = np.asarray(jc._proj())
    pc = pcd.EmbeddingCodec(NF, d_model=16, n_frames=3, seed=5, proj=proj)
    want = np.asarray(jc.encode(js, jnp.asarray(feats)))
    got = pc.encode(ps, torch.from_numpy(feats))
    assert got.shape == (E, 3, 16)
    assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(NotImplementedError):
        pc.decode(ps, got, -1.0, 1.0)
    with pytest.raises(ValueError, match="proj"):
        pcd.EmbeddingCodec(NF, d_model=8, proj=proj).encode(
            ps, torch.from_numpy(feats))
    own = pcd.EmbeddingCodec(NF, d_model=16, n_frames=3, seed=5)
    a = own.encode(ps, torch.from_numpy(feats))
    assert torch.equal(a, own.encode(ps, torch.from_numpy(feats)))
    assert a.shape == (E, 3, 16) and bool(torch.isfinite(a).all())
