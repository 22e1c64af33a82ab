"""The port's RG-LRU, RWKV-6 and MoE blocks and the ``embeddings``/``vlm``
frontends against the JAX package's, on the CPU.

Every test feeds the same seeded numpy inputs through the JAX function and
its port. Weights are the reference's draws (``param.init`` of its defs,
or ``LM.init`` moved across with ``convert.lm_params_from_numpy``): JAX's
threefry draws cannot be reproduced in torch, so the port's own draw
(``ParamDef`` ``uniform``/``normal``) serves the card runs only.

Tolerances, as ``tests/test_torch_lm.py`` states them:
  * ``TOL``: 1e-4 absolute and relative, float32 on both sides. The two
    differ in summation order only (XLA's dots and its associative scan
    against torch's matmuls and the sequential plain scan); the RG-LRU
    recurrence seeded with a non-zero h0 is seeded differently (the
    reference adds a_0 h0 into b_0, the kernel takes h0), which rounds
    alike but not always bit for bit, within ``SCAN_TOL`` (1e-6).
  * ``BF16_TOL``: rtol 2^-7 (one bfloat16 ulp) plus atol 0.05 on the
    logits, mean absolute difference <= 1e-2: both sides round at the
    same places but add in other orders.
Named numerical traps, each pinned by a test here: ``jax.nn.gelu`` is the
tanh form; RWKV's group norm takes the population variance; ``_conv_full``
sums its taps from 0 in the activation dtype (bit for bit in bfloat16);
the MoE capacity drops assignments, which the test asserts happened; ties
in ``top_k`` would order differently between the two packages, and the
seeded router probabilities here have none (a test asserts it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import LM as JaxLM
from repro.models import moe as jmoe
from repro.models import param as jparam
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import registry as preg
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.models import moe as pmoe
from repro_torch.models import param as pparam
from repro_torch.models import rglru as prglru
from repro_torch.models import rwkv6 as prwkv
from repro_torch.serve import engine as pengine

TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.05)
FAMILIES = ["recurrentgemma-2b", "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b",
            "moonshot-v1-16b-a3b", "musicgen-medium", "internvl2-26b"]
CASES = [(a + ":smoke", {}, 0) for a in FAMILIES] + [
    ("recurrentgemma-2b:smoke", {"n_layers": 5}, 0),   # 1 group + 2 tail
    ("rwkv6-1.6b:smoke", {}, 4)]                       # chunked wkv
IDS = ["recurrentgemma", "rwkv6", "phi3.5-moe", "moonshot", "musicgen",
       "internvl2", "recurrentgemma-tail", "rwkv6-chunked"]


def _cfgs(arch, overrides=None):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        pcfg = dataclasses.replace(pcfg, **overrides)
    return jcfg, pcfg


def _pair(arch, overrides=None, rwkv_chunk=0, seed=0):
    jcfg, pcfg = _cfgs(arch, overrides)
    jm = JaxLM(jcfg, remat_policy="none", rwkv_chunk=rwkv_chunk)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = LM(pcfg, device="cpu", rwkv_chunk=rwkv_chunk,
            params=lm_params_from_numpy(jax.tree.map(np.asarray, jp), pcfg))
    return jm, jp, pm, pcfg


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _module_params(defs, seed=0):
    """The reference's draw of a block's params, on both sides (float32)."""
    jp = jparam.init(defs, jax.random.PRNGKey(seed))
    return jp, {k: _t(v) for k, v in jp.items()}


def _assert_cache(jcache, pcache, cfg, tol=TOL):
    want = lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg)
    assert torch.equal(want["lengths"], pcache["lengths"])
    assert len(want["layers"]) == len(pcache["layers"]) == cfg.n_layers
    for w, g in zip(want["layers"], pcache["layers"]):
        assert set(w) == set(g)
        for key in w:
            assert w[key].shape == g[key].shape and \
                w[key].dtype == g[key].dtype, key
            assert_allclose(g[key].float().numpy(), w[key].float().numpy(),
                            **tol)


def _prompt(cfg, rng, B, S):
    """numpy inputs of a prefill: frames for ``embeddings``; tokens, and
    patches for ``vlm``."""
    if cfg.frontend == "embeddings":
        return {"frames": rng.normal(0, 1, (B, S, cfg.d_model))
                .astype(np.float32)}
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vlm":
        out["patches"] = rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return out


def _step(cfg, rng, B):
    if cfg.frontend == "embeddings":
        return {"frames": rng.normal(0, 1, (B, 1, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, 1))
            .astype(np.int32)}


def _to_jax(inputs, cfg):
    dt = jnp.dtype(cfg.dtype)
    return {k: jnp.asarray(v) if v.dtype == np.int32 else
            jnp.asarray(v).astype(dt) for k, v in inputs.items()}


def _to_torch(inputs, cfg):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    return {k: torch.from_numpy(v) if v.dtype == np.int32 else
            torch.from_numpy(v).to(dt) for k, v in inputs.items()}


def _run_both(jm, jp, pm, cfg, rng, steps=4, B=2, S=40):
    """Prefill S positions, then decode ``steps`` more, on both sides:
    yields (port logits, reference logits, reference cache, port cache)."""
    prompt = _prompt(cfg, rng, B, S - (cfg.n_patches if cfg.frontend ==
                                       "vlm" else 0))
    jl, jc = jax.jit(lambda p, i: jm.prefill(p, i, max_seq=S + steps))(
        jp, _to_jax(prompt, cfg))
    pl, pc = pm.prefill(_to_torch(prompt, cfg), max_seq=S + steps)
    assert pl.dtype == torch.float32 and pl.shape == (B, cfg.vocab_size)
    assert int(pc["lengths"][0]) == S
    yield pl, np.asarray(jl, np.float32), jc, pc
    dec = jax.jit(jm.decode_step)
    for _ in range(steps):
        nt = _step(cfg, rng, B)
        jl, jc = dec(jp, _to_jax(nt, cfg), jc)
        pl, pc = pm.decode_step(_to_torch(nt, cfg), pc)
        yield pl, np.asarray(jl, np.float32), jc, pc


# ------------------------------------------------------------- the LM
@pytest.mark.parametrize("arch,overrides,chunk", CASES, ids=IDS)
def test_lm_prefill_and_decode_match_jax(arch, overrides, chunk, rng):
    """Prefill plus 4 decode steps; logits and every cache leaf after each
    (K/V, RG-LRU conv and h, RWKV shifts and wkv)."""
    jm, jp, pm, cfg = _pair(arch, overrides, chunk)
    assert pm.param_count() == jm.param_count()
    assert sum(p.numel() for p in pm.parameters()) == pm.param_count()
    for pl, jl, jc, pc in _run_both(jm, jp, pm, cfg, rng):
        assert_allclose(pl.numpy(), jl, **TOL)
        _assert_cache(jc, pc, cfg)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b:smoke",
                                  "rwkv6-1.6b:smoke",
                                  "moonshot-v1-16b-a3b:smoke"],
                         ids=["recurrentgemma", "rwkv6", "moonshot"])
def test_lm_matches_jax_bf16(arch, rng):
    """The recurrent and MoE families in bfloat16 on both sides."""
    jm, jp, pm, cfg = _pair(arch, BF16)
    assert pm.embed["table"].dtype == torch.bfloat16
    for pl, jl, _, pc in _run_both(jm, jp, pm, cfg, rng):
        assert np.isfinite(pl.numpy()).all()
        assert_allclose(pl.numpy(), jl, **BF16_TOL)
        assert np.abs(pl.numpy() - jl).mean() <= 1e-2
    for layer in pc["layers"]:
        for key in ("h", "wkv"):   # recurrent states stay float32
            if key in layer:
                assert layer[key].dtype == torch.float32


def _no_drop(cfg):
    """A capacity that cannot drop: C >= T for any load (E / k)."""
    if cfg.moe is None:
        return {}
    return {"moe": dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts /
        cfg.moe.experts_per_token)}


@pytest.mark.parametrize("arch,overrides,chunk", CASES, ids=IDS)
def test_decode_matches_prefill(arch, overrides, chunk, rng):
    """Within the port: prefill 8 positions with room for the rest, decode
    the remaining ones, and land on the full prefill's last logits (the
    RG-LRU and RWKV states carried, the local ring wrapped at 40 > 32).
    MoE configs run at a capacity that cannot drop: decode equals prefill
    only where neither drops (capacity is per call, ``moe_apply``), and
    the counts confirm none did."""
    _, pcfg = _cfgs(arch, overrides)
    pcfg = dataclasses.replace(pcfg, **_no_drop(pcfg))
    pm = LM(pcfg, device="cpu", rwkv_chunk=chunk, seed=1)
    pm.moe_counts = []
    B, S = 2, 40
    n_pre = 8
    prompt = _to_torch(_prompt(pcfg, rng, B, S), pcfg)
    seq = "frames" if pcfg.frontend == "embeddings" else "tokens"
    full, _ = pm.prefill(prompt)
    head = dict(prompt, **{seq: prompt[seq][:, :n_pre]})
    extra = pcfg.n_patches if pcfg.frontend == "vlm" else 0
    _, cache = pm.prefill(head, max_seq=S + extra + 1)
    for t in range(n_pre, S):
        logits, cache = pm.decode_step({seq: prompt[seq][:, t:t + 1]}, cache)
    assert (cache["lengths"] == S + extra).all()
    assert_allclose(logits.numpy(), full.numpy(), **TOL)
    if pcfg.moe is not None:
        assert len(pm.moe_counts) == pcfg.n_layers * (2 + S - n_pre)
        assert sum(int(c[0]) for c in pm.moe_counts) == 0


def test_tail_layers_follow_the_groups():
    """recurrentgemma at 5 layers: one (RGLRU, RGLRU, LOCAL) group and a
    2-layer (RGLRU, RGLRU) tail, in model order on the port's side."""
    _, pcfg = _cfgs("recurrentgemma-2b:smoke", {"n_layers": 5})
    assert pcfg.n_groups == 1 and pcfg.n_remainder_layers == 2
    pm = LM(pcfg, device="cpu")
    kinds = [next(iter(set(layer) - {"ffn"})) for layer in pm.layers]
    assert kinds == ["rglru", "rglru", "attn", "rglru", "rglru"]


def test_every_arch_serves_on_cpu(rng):
    """Every architecture of the registry constructs, prefills and decodes
    at ``:smoke``."""
    for arch in preg.ARCH_IDS:
        cfg = preg.get_config(arch + ":smoke")
        pm = LM(cfg, device="cpu")
        logits, cache = pm.prefill(_to_torch(_prompt(cfg, rng, 2, 6), cfg),
                                   max_seq=cfg.n_patches + 8)
        logits, cache = pm.decode_step(_to_torch(_step(cfg, rng, 2), cfg),
                                       cache)
        assert logits.shape == (2, cfg.vocab_size), arch
        assert torch.isfinite(logits).all(), arch


def test_engine_refuses_frame_input():
    """The reference's engine feeds token ids and would fail on musicgen
    with a KeyError; the port refuses it up front."""
    pm = LM(preg.get_config("musicgen-medium:smoke"), device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        pengine.ServeEngine(pm, batch_slots=2, max_seq=16)


# ------------------------------------------------------------ RG-LRU
def test_rglru_apply_and_step_match_jax(rng):
    jcfg, pcfg = _cfgs("recurrentgemma-2b:smoke")
    jp, pp = _module_params(jrglru.rglru_defs(jcfg))
    x = rng.normal(0, 1, (2, 13, jcfg.d_model)).astype(np.float32)
    jout, (jconv, jh) = jrglru.rglru_apply(jp, _j(x), jcfg,
                                           return_state=True)
    pout, (pconv, ph) = prglru.rglru_apply(pp, _t(x), pcfg,
                                           return_state=True)
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    assert_allclose(pconv.numpy(), np.asarray(jconv), **TOL)
    assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    xs = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
    jout, (jconv, jh) = jrglru.rglru_step(jp, _j(xs), jcfg, jconv, jh)
    pout, (pconv, ph) = prglru.rglru_step(pp, _t(xs), pcfg, pconv, ph)
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    assert_allclose(pconv.numpy(), np.asarray(jconv), **TOL)
    assert_allclose(ph.numpy(), np.asarray(jh), **TOL)


def test_rglru_scan_with_h0_matches_jax(rng):
    """The reference seeds the recurrence by adding a_0 h0 into b_0; the
    kernel's wrapper takes h0 itself. Within ``SCAN_TOL``."""
    a = rng.uniform(0.5, 1.0, (3, 50, 24)).astype(np.float32)
    b = rng.normal(0, 1, (3, 50, 24)).astype(np.float32)
    h0 = rng.normal(0, 1, (3, 24)).astype(np.float32)
    want = np.asarray(jrglru.rglru_scan(_j(a), _j(b), _j(h0)))
    hs, h_last = prglru.rglru_scan(_t(a), _t(b), _t(h0))
    assert_allclose(hs.numpy(), want, **SCAN_TOL)
    assert torch.equal(h_last, hs[:, -1])
    # without h0 the recurrence starts from zeros, as the reference's
    want0 = np.asarray(jrglru.rglru_scan(_j(a), _j(b)))
    assert_allclose(prglru.rglru_scan(_t(a), _t(b))[0].numpy(), want0,
                    **SCAN_TOL)


def test_gelu_is_the_tanh_form(rng):
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's gate
    branch uses ``F.gelu(approximate="tanh")``, which the erf form would
    miss by far more than the tolerance."""
    x = rng.normal(0, 3, (4096,)).astype(np.float32)
    want = np.asarray(jax.nn.gelu(_j(x)))
    got = prglru._gelu(_t(x), torch.float32).numpy()
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(_t(x)).numpy() - want).max() > 1e-4


def test_conv_full_sums_taps_like_jax_in_bf16(rng):
    """``_conv_full`` adds its W taps one at a time from 0 in the
    activation dtype (the reference's Python ``sum``), so in bfloat16 the
    result rounds after every tap, bit for bit as the reference's."""
    jcfg, _ = _cfgs("recurrentgemma-2b:smoke", BF16)
    jp = jparam.init(jrglru.rglru_defs(jcfg), jax.random.PRNGKey(0))
    conv = {k: jp[k] for k in ("conv_w", "conv_b")}
    x = jnp.asarray(rng.normal(0, 1, (2, 17, jcfg.d_model)), jnp.bfloat16)
    want, want_state = jrglru._conv_full(conv, x)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    got, state = prglru._conv_full({k: bf(v) for k, v in conv.items()},
                                   bf(x))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert np.array_equal(state.float().numpy(),
                          np.asarray(want_state, np.float32))


# -------------------------------------------------------------- RWKV
def _rwkv_state(cfg, rng, B):
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"shift": rng.normal(0, 1, (B, cfg.d_model)).astype(np.float32),
            "wkv": rng.normal(0, 0.1, (B, H, hd, hd)).astype(np.float32)}


@pytest.mark.parametrize("chunk", [0, 4, 5], ids=["scan", "chunk4",
                                                  "chunk5"])
def test_time_mix_matches_jax(chunk, rng):
    """Both wkv branches from a carried state, S = 13 (not a multiple of
    either chunk, so the pad path runs)."""
    jcfg, pcfg = _cfgs("rwkv6-1.6b:smoke")
    jp, pp = _module_params(jrwkv.rwkv_defs(jcfg))
    x = rng.normal(0, 1, (2, 13, jcfg.d_model)).astype(np.float32)
    st = _rwkv_state(jcfg, rng, 2)
    jout, jst = jrwkv.time_mix(jp, _j(x), jcfg,
                               {k: _j(v) for k, v in st.items()},
                               chunk=chunk, return_state=True)
    pout, pst = prwkv.time_mix(pp, _t(x), pcfg,
                               {k: _t(v) for k, v in st.items()},
                               chunk=chunk, return_state=True)
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    for k in ("shift", "wkv"):
        assert_allclose(pst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_time_mix_step_and_channel_mix_match_jax(rng):
    jcfg, pcfg = _cfgs("rwkv6-1.6b:smoke")
    jp, pp = _module_params(jrwkv.rwkv_defs(jcfg))
    x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
    st = _rwkv_state(jcfg, rng, 2)
    jout, jst = jrwkv.time_mix_step(jp, _j(x), jcfg,
                                    {k: _j(v) for k, v in st.items()})
    pout, pst = prwkv.time_mix_step(pp, _t(x), pcfg,
                                    {k: _t(v) for k, v in st.items()})
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    for k in ("shift", "wkv"):
        assert_allclose(pst[k].numpy(), np.asarray(jst[k]), **TOL)
    xs = rng.normal(0, 1, (2, 9, jcfg.d_model)).astype(np.float32)
    shift = st["shift"]
    jout, jsh = jrwkv.channel_mix(jp, _j(xs), jcfg, _j(shift),
                                  return_state=True)
    pout, psh = prwkv.channel_mix(pp, _t(xs), pcfg, _t(shift),
                                  return_state=True)
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    assert torch.equal(psh, _t(xs)[:, -1])
    assert_allclose(psh.numpy(), np.asarray(jsh), **TOL)


def test_group_norm_takes_the_population_variance(rng):
    """``jnp.var`` is the population variance; ``torch.var`` defaults to
    Bessel's correction, which at hd = 16 would scale the output by
    sqrt(15/16), far outside the tolerance."""
    x = rng.normal(0, 1, (2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(0, 0.1, (64,)).astype(np.float32)
    want = np.asarray(jrwkv._group_norm(_j(x), _j(scale), 1e-6))
    got = prwkv._group_norm(_t(x), _t(scale), 1e-6).numpy()
    assert_allclose(got, want, **TOL)
    xf = _t(x)
    bessel = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, keepdim=True) + 1e-6)
    bessel = (bessel.reshape(2, 5, -1) * (1 + _t(scale))).numpy()
    assert np.abs(bessel - want).max() > 1e-2


# --------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch,B,S,drops", [
    ("phi3.5-moe-42b-a6.6b:smoke", 2, 8, False),
    ("moonshot-v1-16b-a3b:smoke", 4, 40, True)],
    ids=["phi3.5-no-drop", "moonshot-drops"])
def test_moe_apply_matches_jax(arch, B, S, drops, rng):
    """Out and aux loss against the reference; the moonshot case (160
    tokens, 8 experts, top 2: C = 50) drops assignments, which the counts
    show."""
    jcfg, pcfg = _cfgs(arch)
    if not drops:
        jcfg = dataclasses.replace(jcfg, **_no_drop(jcfg))
        pcfg = dataclasses.replace(pcfg, **_no_drop(pcfg))
    jp, pp = _module_params(jmoe.moe_defs(jcfg))
    x = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_apply(jp, _j(x), jcfg)
    counts = []
    pout, paux = pmoe.moe_apply(pp, _t(x), pcfg, counts=counts)
    assert pmoe.capacity(B * S, pcfg.moe) == jmoe.capacity(B * S, jcfg.moe)
    assert_allclose(pout.numpy(), np.asarray(jout), **TOL)
    assert_allclose(float(paux), float(jaux), **TOL)
    dropped, total = (int(c) for c in counts[0])
    assert total == B * S * pcfg.moe.experts_per_token
    assert (dropped > 0) == drops
    # no ties among each token's router probabilities at this seed: the
    # two packages' top_k would order them differently
    logits = _t(x).reshape(-1, pcfg.d_model) @ pp["router"]
    top = torch.softmax(logits, -1).topk(pcfg.moe.experts_per_token + 1,
                                         -1).values
    assert (top[:, :-1] - top[:, 1:] > 0).all()


def test_moe_combines_in_ascending_expert_order(rng):
    """A token's k contributions are added in ascending expert id, as the
    reference's scatter-add meets them after its stable sort: in bfloat16
    the port equals the reference bit for bit on most elements, and where
    not, by one ulp (the expert products add in another order)."""
    jcfg, pcfg = _cfgs("moonshot-v1-16b-a3b:smoke", BF16)
    jp = jparam.init(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    x = jnp.asarray(rng.normal(0, 1, (2, 16, jcfg.d_model)), jnp.bfloat16)
    want = np.asarray(jmoe.moe_apply(jp, x, jcfg)[0], np.float32)
    got = pmoe.moe_apply({k: bf(v) for k, v in jp.items()}, bf(x),
                         pcfg)[0].float().numpy()
    assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    assert (got == want).mean() >= 0.9


# ---------------------------------------------------------- init
def test_uniform_init_draws_in_range():
    """The reference's ``custom`` uniform leaves, drawn by the port: lam in
    [0.9, 0.999] (softplus ~1.28, not the 0.69 of a N(0, 0.02) draw), mu
    and cm_mu in [0, 1], decay_base in [-1, 1]."""
    cfg = preg.get_config("recurrentgemma-2b:smoke")
    lam = LM(cfg, device="cpu").layers[0]["rglru"]["lam"]
    assert 0.9 <= lam.min() and lam.max() < 0.999 and lam.std() > 0.01
    rw = LM(preg.get_config("rwkv6-1.6b:smoke"), device="cpu").layers[0][
        "rwkv"]
    for key, lo, hi in (("mu", 0, 1), ("cm_mu", 0, 1),
                        ("decay_base", -1, 1)):
        v = rw[key]
        assert lo <= v.min() and v.max() < hi and v.std() > 0.1, key
    d = pparam.ParamDef((4,), ("x",), torch.bfloat16, "uniform", low=2.0,
                        high=3.0)
    g = torch.Generator().manual_seed(0)
    v = d.materialize(g, "cpu")
    assert v.dtype == torch.bfloat16 and (v >= 2).all() and (v <= 3).all()
