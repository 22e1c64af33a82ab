"""float16 models on the port against the JAX package's, on the CPU.

The reference computes in whatever ``jnp.dtype(cfg.dtype)`` names; with
``dtype = param_dtype = "float16"`` both packages carry the same float16
weights (the reference's ``LM.init`` moved across with
``convert.lm_params_from_numpy``) and see the same inputs. Archs:
qwen3 and gemma2 (softcaps, a local window ring, post-norms),
recurrentgemma (RG-LRU, its scan operands float32 as the reference casts
them), rwkv6 and moonshot (MoE), each ``:smoke``.

Tolerances. Both sides round at the same places, as in bfloat16
(``tests/test_torch_lm.py``), but add in other orders (XLA's dots and
scans against torch's matmuls, the flash plain version keeping p in
float32 where the reference's jnp attention rounds it), so hidden states
differ by single float16 ulps:
  * ``F16_TOL``: logits within rtol 2^-10 (one float16 ulp) plus atol
    1e-2, and their mean absolute difference within 2e-3 (observed: 0 to
    2.4e-4 for qwen3 and rwkv6, 3.8e-3 max and 6.6e-4 mean for gemma2,
    whose logits reach ~5, where an ulp is 2^-8);
  * ``F16_CACHE_TOL``: every cache leaf within rtol 2^-9 (two ulps) plus
    atol 1e-3 (observed <= one ulp of leaves below 1, 4.9e-4);
  * the engine: every step's logits within ``F16_TOL``, and the tokens
    equal where the reference's top-2 gap exceeds atol;
  * loss and grads: the loss and its ce within rtol 1e-4 (float32 from
    float32 logits of float16 hidden states; observed 4.7e-6), every grad
    leaf within 2^-6 of its largest magnitude (gradients flow back through
    float16 activations, which round at ulps of 2^-11 relative; observed
    3.3e-3).
``test_float16_rounding_matches_jax`` holds the layers that make a
rounding choice (q pre-scaled by a scale rounded to float16, the tied
embedding scaled in float16, rms_norm in float32 cast back) to the
reference bit for bit, and rope (float32 cast back) to one ulp. Without
``"float16"`` in the port's ``dtype_of`` every test here raises
``KeyError``.
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
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro_torch.configs import registry as preg
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import LM
from repro_torch.models import layers as players
from repro_torch.serve import engine as pengine
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import tree as tr

F16 = dict(dtype="float16", param_dtype="float16")
F16_TOL = dict(rtol=2.0 ** -10, atol=1e-2)
F16_MEAN = 2e-3
F16_CACHE_TOL = dict(rtol=2.0 ** -9, atol=1e-3)
ARCHS = ["qwen3-0.6b", "gemma2-2b", "recurrentgemma-2b", "rwkv6-1.6b",
         "moonshot-v1-16b-a3b"]


def _pair(arch):
    jcfg = dataclasses.replace(jreg.get_config(arch + ":smoke"), **F16)
    pcfg = dataclasses.replace(preg.get_config(arch + ":smoke"), **F16)
    jm = JaxLM(jcfg, remat_policy="none")
    jp = jm.init(jax.random.PRNGKey(0))
    pm = LM(pcfg, device="cpu", params=lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg))
    return jm, jp, pm, pcfg


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert np.isfinite(got).all()
    assert_allclose(got, want, **F16_TOL)
    assert np.abs(got - want).mean() <= F16_MEAN


def _assert_cache(jcache, pcache, cfg):
    want = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg)
    assert torch.equal(want["lengths"], pcache["lengths"])
    assert len(want["layers"]) == len(pcache["layers"]) == cfg.n_layers
    for w, g in zip(want["layers"], pcache["layers"]):
        assert set(w) == set(g)
        for key in w:
            assert w[key].shape == g[key].shape and \
                w[key].dtype == g[key].dtype, key
            assert_allclose(g[key].float().numpy(), w[key].float().numpy(),
                            **F16_CACHE_TOL)


def test_dtype_of_takes_the_reference_model_dtypes():
    assert [players.dtype_of(n) for n in ("float32", "bfloat16", "float16")] \
        == [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("arch", ARCHS)
def test_float16_prefill_and_decode_match_jax(arch, rng):
    """Prefill 40 tokens, then 4 decode steps, on both sides: the logits
    after each, and every cache leaf after the prefill and the last step;
    the weights and the caches stay float16 (recurrentgemma's ``h`` and
    rwkv6's ``wkv`` float32, as the reference keeps them)."""
    jm, jp, pm, cfg = _pair(arch)
    assert pm.embed["table"].dtype == torch.float16
    B, S = 2, 40
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, i: jm.prefill(p, i, max_seq=S + 4))(
        jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill({"tokens": torch.from_numpy(toks)}, max_seq=S + 4)
    assert pl.dtype == torch.float32
    _close(pl, np.asarray(jl, np.float32))
    _assert_cache(jc, pc, cfg)
    dec = jax.jit(jm.decode_step)
    for _ in range(4):
        nt = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = dec(jp, {"tokens": jnp.asarray(nt)}, jc)
        pl, pc = pm.decode_step({"tokens": torch.from_numpy(nt)}, pc)
        _close(pl, np.asarray(jl, np.float32))
    _assert_cache(jc, pc, cfg)


def test_float16_rounding_matches_jax(rng):
    """The rounding choices copied from the reference, bit for bit in
    float16, at widths whose scales are not exact in float16 (1/sqrt(128)
    and sqrt(72)): ``scale_by``, the tied embedding, rms_norm. rope
    computes in float32 and casts back as the reference does, but torch's
    and XLA's float32 sin and cos differ in the last bit for ~5% of the
    angles, which moves ~5e-5 of the float16 outputs by an ulp: it is
    held to one ulp (atol 2^-20 where a rotation cancels to near zero,
    which the float32 difference moves by more ulps of the small result)
    and to 99.9% of its outputs bit-equal (rounding in float16 where the
    reference does not would leave far fewer equal)."""
    hf = lambda a: jnp.asarray(a, jnp.float16)
    th = lambda a: torch.from_numpy(np.asarray(a, np.float16))

    def same(got, want):
        return np.array_equal(got.numpy(), np.asarray(want))

    x = rng.normal(0, 1, (2, 40, 8, 128)).astype(np.float16)
    assert same(players.scale_by(th(x), 1 / math.sqrt(128)),
                hf(x) * (1 / math.sqrt(128)))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    got = players.rope(th(x), torch.from_numpy(pos.copy()), 1e6).numpy()
    want = np.asarray(jlayers.rope(hf(x), jnp.asarray(pos), 1e6))
    assert got.dtype == want.dtype == np.float16
    assert_allclose(got.astype(np.float32), want.astype(np.float32),
                    rtol=2.0 ** -10, atol=2.0 ** -20)
    assert (got == want).mean() >= 0.999
    d = 72
    jcfg = dataclasses.replace(jreg.get_config("qwen3-0.6b:smoke"), d_model=d,
                               **F16)
    pcfg = dataclasses.replace(preg.get_config("qwen3-0.6b:smoke"), d_model=d,
                               **F16)
    table = rng.normal(0, d ** -0.5, (jcfg.vocab_size, d)).astype(np.float16)
    toks = rng.randint(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    assert same(players.embed_tokens({"table": th(table)},
                                     torch.from_numpy(toks), pcfg),
                jlayers.embed_tokens({"table": hf(table)}, jnp.asarray(toks),
                                     jcfg))
    h = rng.normal(0, 1, (2, 40, d)).astype(np.float16)
    w = rng.normal(0, 0.1, (d,)).astype(np.float16)
    assert same(players.rms_norm(th(h), th(w), 1e-6),
                jlayers.rms_norm(hf(h), hf(w), 1e-6))


def _recording(engine, log):
    step = engine._step_masked

    def run(tokens, mask):
        logits = step(tokens, mask)
        log.append(np.asarray(logits if not torch.is_tensor(logits)
                              else logits.numpy(), np.float32))
        return logits
    engine._step_masked = run


def test_float16_engine_matches_jax():
    """qwen3 in float16 through both ServeEngines: 5 requests on 2 slots
    (a slot reused), every step's logits within ``F16_TOL``, the tokens
    where the reference's top-2 gap exceeds its atol, and the stats."""
    jm, jp, pm, cfg = _pair("qwen3-0.6b")
    je = jengine.ServeEngine(jm, jp, batch_slots=2, max_seq=48)
    pe = pengine.ServeEngine(pm, batch_slots=2, max_seq=48)
    jlog, plog = [], []
    _recording(je, jlog)
    _recording(pe, plog)
    reqs = []
    for mod in (jengine, pengine):
        rng = np.random.RandomState(0)
        reqs.append([mod.Request(rid=i, prompt=rng.randint(
            1, cfg.vocab_size, (5,)).astype(np.int32), max_new_tokens=6)
            for i in range(5)])
    je.run_until_drained(reqs[0])
    pe.run_until_drained(reqs[1])
    assert len(plog) == len(jlog) > 0
    clear = True
    for want, got in zip(jlog, plog):
        _close(got, want)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear &= bool((top2[:, 1] - top2[:, 0] > F16_TOL["atol"]).all())
    assert clear, "a near-tie: pick another seed"
    for j, p in zip(*reqs):
        assert p.tokens == j.tokens and p.done and j.done
    assert pe.stats == je.stats and pe.stats["admitted"] == 5


def test_float16_loss_and_grads_match_jax():
    """qwen3's ``LM.loss`` and every gradient leaf in float16 against
    ``jax.value_and_grad`` of the reference's, on one synthetic batch."""
    from repro.data.pipeline import SyntheticLMStream
    jm, jp, pm, cfg = _pair("qwen3-0.6b")
    b = SyntheticLMStream(cfg.vocab_size, 2, 24, seed=0).make_batch(0)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    params = tr.map_(lambda x: x.detach(), pm.params())
    loss, met, grads = loss_and_grads(
        pm, params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-4)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jg), cfg)
    got_l, want_l = tr.leaves(grads), tr.leaves(want)
    assert len(got_l) == len(want_l) == len(tr.leaves(params))
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float16
        scale = float(w.float().abs().max())
        assert_allclose(g.float().numpy(), w.float().numpy(), rtol=0.0,
                        atol=2.0 ** -6 * max(scale, 1e-12))


def test_float16_checkpoint_round_trip(tmp_path):
    """float16 weights saved by the port restore bit for bit in the port
    and in the reference (manifest dtype ``float16``, one leaf file each,
    the same tree order), and the reference's float16 checkpoint of its
    own params restores bit for bit in the port."""
    jm, jp, pm, cfg = _pair("qwen3-0.6b")
    params = pm.params()
    ck = pckpt.Checkpointer(str(tmp_path / "port"), async_mode=False)
    ck.save(3, params)
    got, _ = ck.restore(3, params)
    for g, w in zip(tr.leaves(got), tr.leaves(params)):
        assert g.dtype == torch.float16 and torch.equal(g, w)
    jlike = tr.map_(lambda x: jnp.zeros(x.shape, jnp.float16), params)
    jgot, _ = jckpt.Checkpointer(str(tmp_path / "port"),
                                 async_mode=False).restore(3, jlike)
    for g, w in zip(jax.tree.leaves(jgot), tr.leaves(params)):
        assert g.dtype == jnp.float16 and np.array_equal(np.asarray(g),
                                                         w.numpy())
    jck = jckpt.Checkpointer(str(tmp_path / "ref"), async_mode=False)
    jck.save(5, jp)
    jck.flush()
    like = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    got, _ = pckpt.Checkpointer(str(tmp_path / "ref"),
                                async_mode=False).restore(5, like)
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    got_l = tr.leaves(got)
    assert len(got_l) == len(leaves)
    for g, w in zip(got_l, leaves):
        assert g.dtype == torch.float16 and np.array_equal(g.numpy(), w)
