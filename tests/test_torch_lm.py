"""The port's LM serving path against the JAX package's, on the CPU.

Both models carry the same weights: the reference's ``LM.init`` params,
moved across with ``convert.lm_params_from_numpy`` (JAX's threefry draws
cannot be reproduced in torch). Configs are the ``:smoke`` reductions in
float32; gemma2 covers local-window ring caches (window 32, wrapped by a
40-token prompt), post-norms and both softcaps, and a 3-layer gemma2
covers the reference's unscanned ``tail`` layer. The smoke weights (scale
0.02) keep attention scores below 0.1, where gemma2's cap of 50 changes
nothing, so one more gemma2 case caps them at 0.05 to make the attention
softcap move the logits (the final cap of 30 already does, on logits of
up to ~5).

Tolerance: 1e-4 absolute and relative on logits and caches. Both sides
compute in float32 and differ only in summation order (XLA's dots and
blockwise online softmax against torch's matmuls and the flash-attention
plain version); the observed gap is ~2e-6.

In bfloat16 the two sides round at the same places but not always the same
way (the reference rounds p to bfloat16 before PV in its jnp attention, the
port's plain flash-attention keeps it in float32; dots add in other
orders), so hidden states differ by single bfloat16 ulps and the logits by
up to ~0.03 (one ulp at |logit| in [4, 8) is 2^-5). The bfloat16 logits
are held to rtol 2^-7 (one ulp) plus atol 0.05, and their mean absolute
difference to 1e-2 (observed 0.03 and 6e-3 for gemma2, half that for
qwen3). That bound cannot see a rounding choice of ~1e-4 relative, such as
the scale 1/sqrt(Dh) rounded to bfloat16 or not, so
``test_bf16_rounding_matches_jax`` holds the layers that make those choices
to the reference bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import LM as JaxLM
from repro.models import layers as jlayers
from repro_torch.configs import registry as preg
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.models import layers as players

TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.05)
CASES = [("qwen3-0.6b:smoke", {}), ("gemma2-2b:smoke", {}),
         ("gemma2-2b:smoke", {"n_layers": 3}),
         ("gemma2-2b:smoke", {"attn_logit_softcap": 0.05})]
IDS = ["qwen3", "gemma2", "gemma2-tail", "gemma2-attn-softcap"]


def _pair(arch, overrides=None):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        pcfg = dataclasses.replace(pcfg, **overrides)
    jm = JaxLM(jcfg, remat_policy="none")
    jp = jm.init(jax.random.PRNGKey(0))
    pm = LM(pcfg, device="cpu", params=lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg))
    return jm, jp, pm, pcfg


def _assert_cache(jcache, pcache, cfg):
    want = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg)
    assert torch.equal(want["lengths"], pcache["lengths"])
    assert len(want["layers"]) == len(pcache["layers"]) == cfg.n_layers
    for w, g in zip(want["layers"], pcache["layers"]):
        for key in ("k", "v"):
            assert w[key].shape == g[key].shape
            assert_allclose(g[key].numpy(), w[key].numpy(), **TOL)


def test_configs_equal_the_reference():
    assert preg.ARCH_IDS == jreg.ARCH_IDS
    for arch in jreg.ARCH_IDS:
        for a in (arch, arch + ":smoke"):
            assert dataclasses.asdict(preg.get_config(a)) == \
                dataclasses.asdict(jreg.get_config(a))


def _run_both(jm, jp, pm, cfg, rng, steps=4):
    """Prefill 40 tokens, then decode ``steps`` more, on both sides: yields
    (port logits, reference logits as float32 numpy, reference cache, port
    cache) after the prefill and after each step."""
    B, S = 2, 40
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, i: jm.prefill(p, i, max_seq=S + 4))(
        jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill({"tokens": torch.from_numpy(toks)}, max_seq=S + 4)
    assert pl.dtype == torch.float32 and pl.shape == (B, cfg.vocab_size)
    yield pl, np.asarray(jl, np.float32), jc, pc
    dec = jax.jit(jm.decode_step)
    for _ in range(steps):
        nt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = dec(jp, {"tokens": jnp.asarray(nt)}, jc)
        pl, pc = pm.decode_step({"tokens": torch.from_numpy(nt)}, pc)
        yield pl, np.asarray(jl, np.float32), jc, pc


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(arch, overrides, rng):
    jm, jp, pm, cfg = _pair(arch, overrides)
    assert pm.param_count() == jm.param_count()
    for i, (pl, jl, jc, pc) in enumerate(_run_both(jm, jp, pm, cfg, rng)):
        assert_allclose(pl.numpy(), jl, **TOL)
        if i in (0, 4):   # after the prefill and after the last step
            _assert_cache(jc, pc, cfg)


@pytest.mark.parametrize("arch", ["qwen3-0.6b:smoke", "gemma2-2b:smoke"],
                         ids=["qwen3", "gemma2"])
def test_prefill_and_decode_match_jax_bf16(arch, rng):
    """The same run in bfloat16 on both sides (activations and weights)."""
    jm, jp, pm, cfg = _pair(arch, BF16)
    assert pm.embed["table"].dtype == torch.bfloat16
    for pl, jl, _, _ in _run_both(jm, jp, pm, cfg, rng):
        assert np.isfinite(pl.numpy()).all()
        assert_allclose(pl.numpy(), jl, **BF16_TOL)
        assert np.abs(pl.numpy() - jl).mean() <= 1e-2


def test_bf16_rounding_matches_jax(rng):
    """The bfloat16 rounding choices copied from the reference, bit for bit,
    at widths whose scales are not exact in bfloat16 (1/sqrt(128) and
    sqrt(72)): q pre-scaled by a scale rounded to bfloat16, the tied
    embedding scaled in bfloat16, rms_norm and rope in float32 cast back.
    ``lm_head``'s bfloat16 product adds in another order than XLA's, so it
    is held to one bfloat16 ulp and to 99% of its logits bit-equal (a
    float32 product would leave almost none equal)."""
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)

    def same(got, want):
        return np.array_equal(got.float().numpy(), np.asarray(want,
                                                              np.float32))

    x = np.asarray(bf(rng.normal(0, 1, (2, 40, 8, 128))), np.float32)
    assert same(players.scale_by(tb(x), 1 / math.sqrt(128)),
                bf(x) * (1 / math.sqrt(128)))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    assert same(players.rope(tb(x), torch.from_numpy(pos.copy()), 1e6),
                jlayers.rope(bf(x), jnp.asarray(pos), 1e6))

    d = 72
    jcfg = dataclasses.replace(jreg.get_config("qwen3-0.6b:smoke"), d_model=d,
                               **BF16)
    pcfg = dataclasses.replace(preg.get_config("qwen3-0.6b:smoke"), d_model=d,
                               **BF16)
    assert jcfg.tie_embeddings
    table = np.asarray(bf(rng.normal(0, d ** -0.5, (jcfg.vocab_size, d))),
                       np.float32)
    toks = rng.randint(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    assert same(players.embed_tokens({"table": tb(table)},
                                     torch.from_numpy(toks), pcfg),
                jlayers.embed_tokens({"table": bf(table)}, jnp.asarray(toks),
                                     jcfg))
    h = np.asarray(bf(rng.normal(0, 1, (2, 40, d))), np.float32)
    w = np.asarray(bf(rng.normal(0, 0.1, (d,))), np.float32)
    assert same(players.rms_norm(tb(h), tb(w), 1e-6),
                jlayers.rms_norm(bf(h), bf(w), 1e-6))
    got = players.lm_head({"table": tb(table)}, tb(h), pcfg).numpy()
    want = np.asarray(jlayers.lm_head({"table": bf(table)}, bf(h), jcfg))
    assert got.dtype == want.dtype == np.float32
    assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_decode_matches_prefill(arch, overrides, rng):
    """Within the port: prefill 8 tokens with room for the rest, decode the
    remaining ones, and land on the full prefill's last logits (for gemma2
    the 40 tokens wrap its 32-slot ring)."""
    _, _, pm, cfg = _pair(arch, overrides)
    B, S = 2, 40
    toks = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32))
    full, _ = pm.prefill({"tokens": toks})
    _, cache = pm.prefill({"tokens": toks[:, :8]}, max_seq=S + 1)
    for t in range(8, S):
        logits, cache = pm.decode_step({"tokens": toks[:, t:t + 1]}, cache)
    assert (cache["lengths"] == S).all()
    assert_allclose(logits.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 50.0)])
def test_blockwise_attention_matches_jax(window, softcap, rng):
    """The layer that holds the flash-attention kernel, against the
    reference's jnp online-softmax recurrence (ragged S = 70 over its
    32-row chunks). With a softcap, q is scaled by 8 so that scores reach
    tens and the cap changes the output far beyond the tolerance."""
    B, S, Hkv, G, D = 2, 70, 2, 2, 16
    q = rng.normal(0, 8 if softcap else 1, (B, S, Hkv, G, D)).astype(
        np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        kv_valid=jnp.ones((B, S), bool), window=window, softcap=softcap,
        q_chunk=32, kv_chunk=32)
    got = players.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, softcap=softcap)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if softcap:
        uncapped = players.blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window)
        assert np.abs(uncapped.numpy() - np.asarray(want)).max() > 1e-2


def test_lm_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LM(preg.get_config("qwen3-0.6b:smoke"))


def test_params_are_checked(rng):
    _, _, pm, cfg = _pair("qwen3-0.6b:smoke")
    params = {"embed": dict(pm.embed),
              "layers": [{k: dict(v) for k, v in layer.items()}
                         for layer in pm.layers]}
    LM(cfg, device="cpu", params=params)
    table = params["embed"]["table"]
    params["embed"]["table"] = table.double()
    with pytest.raises(ValueError, match="expected"):
        LM(cfg, device="cpu", params=params)
    params["embed"]["table"] = table
    params["layers"] = params["layers"][:1]
    with pytest.raises(ValueError, match="entries"):
        LM(cfg, device="cpu", params=params)
