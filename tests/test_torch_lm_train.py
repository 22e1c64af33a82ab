"""LM training on the port against the JAX package's, on the CPU.

Both sides carry the same weights (the reference's ``LM.init`` moved
across with ``convert.lm_params_from_numpy``) and see the same batches
(``data.pipeline.SyntheticLMStream``, drawn with numpy as the reference
draws them), at ``:smoke`` configs in float32. The JAX gradients have the
params' tree, so they cross with ``lm_params_from_numpy`` too.

Tolerances (float32 on both sides; the two differ in summation order:
XLA's dots, associative scan and online softmax against torch's matmuls,
the plain sequential scan and the plain attention):
  * ``LOSS_TOL``: rtol 1e-5 on the loss, the cross entropy and the MoE aux
    loss (observed ~2e-7);
  * ``GRAD_REL``: every gradient leaf within 1e-4 of the leaf's largest
    magnitude, elementwise (observed ~1e-6);
  * three train steps' losses, ce and lr within ``LOSS_TOL`` and grad
    norms within rtol 1e-4, with AdamW's state carried across by
    ``convert.lm_train_state_from_numpy``;
  * within the port, the remat policies hold bit for bit (the same ops in
    the same order), ``RGLRUScanFn`` against autograd through its plain
    loop bit for bit, ``FlashAttentionFn``'s forward bit for bit against
    ``attention_ref`` and its gradients, the chunked backward from the
    saved logsumexp, within ``ref.backward_error_bound`` of autograd
    through ``attention_ref`` (derived in its docstring and in
    ``test_torch_flash_backward.py``'s), and ``microbatches=2`` against 1 within
    ``LOSS_TOL`` on the loss and 1e-6 on the new params (the per-
    microbatch means add in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import compat
from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import ShardingConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLMStream as JaxStream
from repro.launch.mesh import make_smoke_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import LM as JaxLM
from repro.train import optimizer as jopt
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_train_state_from_numpy)
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                    attention_ref,
                                                    backward_error_bound)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.launch.steps import build_train_step, loss_and_grads
from repro_torch.models import LM
from repro_torch.models.layers import FlashAttentionFn
from repro_torch.models.rglru import RGLRUScanFn
from repro_torch.train import optimizer as popt
from repro_torch.train import tree as tr

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_REL = 1e-4
FAMILIES = ["qwen3-0.6b", "gemma2-2b", "recurrentgemma-2b", "rwkv6-1.6b",
            "moonshot-v1-16b-a3b", "musicgen-medium", "internvl2-26b"]
SEQ, BATCH = 24, 2


def _pair(arch, overrides=None, remat="none"):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        pcfg = dataclasses.replace(pcfg, **overrides)
    jm = JaxLM(jcfg, remat_policy="none")
    jp = jm.init(jax.random.PRNGKey(0))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), pcfg)
    pm = LM(pcfg, device="cpu", params=pp, remat_policy=remat)
    return jcfg, jm, jp, pcfg, pm


def _batch(cfg, index=0, batch=BATCH):
    seq = SEQ + (cfg.n_patches if cfg.frontend == "vlm" else 0)
    return JaxStream(cfg.vocab_size, batch, seq, seed=0,
                     frontend=cfg.frontend, d_model=cfg.d_model,
                     n_patches=cfg.n_patches).make_batch(index)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _params(pm):
    return tr.map_(lambda x: x.detach(), pm.params())


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``LM.loss``, its ce and aux, and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``LM.loss``."""
    jcfg, jm, jp, pcfg, pm = _pair(arch + ":smoke")
    b = _batch(jcfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, met, grads = loss_and_grads(pm, _params(pm), _torch(b))
    assert_allclose(float(loss), float(jl), **LOSS_TOL)
    assert_allclose(float(met["ce"]), float(jmet["ce"]), **LOSS_TOL)
    assert_allclose(float(met["aux"]), float(jmet["aux"]), **LOSS_TOL)
    if pcfg.moe is not None:
        assert float(met["aux"]) > 0.0
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jg), pcfg)
    got_l, want_l = tr.leaves(grads), tr.leaves(want)
    assert len(got_l) == len(want_l) == len(tr.leaves(pm.params()))
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = float(w.abs().max())
        assert_allclose(g.numpy(), w.numpy(), rtol=0.0,
                        atol=GRAD_REL * max(scale, 1e-12))


@pytest.mark.parametrize("arch,overrides", [
    ("qwen3-0.6b:smoke", {}),
    ("recurrentgemma-2b:smoke", {"n_layers": 5}),    # 1 group + 2 tail
], ids=["qwen3", "recurrentgemma-tail"])
def test_three_steps_match_jax(arch, overrides):
    """Three train steps of the port's ``build_train_step`` against the
    reference's on ``make_smoke_mesh()``, from the same params and AdamW
    state (``lm_train_state_from_numpy``) over the same batches: the
    loss, ce, grad norm and lr of every step."""
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    jcfg = dataclasses.replace(jcfg, **overrides)
    pcfg = dataclasses.replace(pcfg, **overrides)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jshape, shape = JaxShape("t", SEQ, BATCH, "train"), \
        ShapeConfig("t", SEQ, BATCH, "train")
    mesh = make_smoke_mesh()
    # the reference's remat changes no number, only its compile time
    jfn, _, _, jm = jax_build_train_step(
        jcfg, jshape, mesh, ShardingConfig(remat_policy="none"),
        tcfg=JaxTrainConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jopt.init(jp)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), pcfg)
    po = lm_train_state_from_numpy(jax.tree.map(np.asarray, jo), pcfg)
    step, _ = build_train_step(pcfg, shape, TrainConfig(**kw), "cpu")
    for i in range(3):
        b = _batch(jcfg, i)
        with compat.set_mesh(mesh):
            jp, jo, jmet = jfn(jp, jo, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        pp, po, met = step(pp, po, _torch(b))
        for k in ("loss", "ce", "lr"):
            assert_allclose(float(met[k]), float(jmet[k]), **LOSS_TOL)
        assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                        rtol=1e-4)
    assert int(po["step"]) == 3


def test_microbatches_two_against_one():
    """``microbatches=2`` accumulates two half-batch gradients in float32
    and divides by 2: the same step as one microbatch, up to the order of
    the adds."""
    _, _, _, pcfg, pm = _pair("qwen3-0.6b:smoke")
    shape = ShapeConfig("t", SEQ, 4, "train")
    b = _torch(_batch(pcfg, 0, batch=4))
    outs = []
    for micro in (1, 2):
        step, _ = build_train_step(pcfg, shape,
                                   TrainConfig(microbatches=micro), "cpu",
                                   model=pm)
        params = _params(pm)
        outs.append(step(params, popt.init(params), b))
    (p1, _, m1), (p2, _, m2) = outs
    assert_allclose(float(m2["loss"]), float(m1["loss"]), **LOSS_TOL)
    for a, c in zip(tr.leaves(p1), tr.leaves(p2)):
        assert_allclose(c.numpy(), a.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(pcfg, ShapeConfig("t", SEQ, 3, "train"),
                         TrainConfig(microbatches=2), "cpu", model=pm)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b:smoke",
                                  "moonshot-v1-16b-a3b:smoke"],
                         ids=["recurrentgemma", "moonshot"])
def test_remat_policies_agree_bit_for_bit(arch):
    """``none``, ``dots`` and ``full`` recompute the same ops in the same
    order: the loss, aux and every gradient are bit-equal."""
    _, _, _, pcfg, pm = _pair(arch)
    b = _torch(_batch(pcfg))
    params = _params(pm)
    runs = []
    for remat in ("none", "dots", "full"):
        pm.remat_policy = remat
        runs.append(loss_and_grads(pm, params, b))
    for loss, met, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert torch.equal(met["aux"], runs[0][1]["aux"])
        assert all(torch.equal(a, c) for a, c in
                   zip(tr.leaves(grads), tr.leaves(runs[0][2])))
    with pytest.raises(ValueError, match="remat_policy"):
        LM(pcfg, device="cpu", remat_policy="some")


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 3.0)])
def test_flash_attention_fn_against_autograd_through_plain(window, softcap):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 12, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 12, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 12, 2, 16, generator=g, requires_grad=True)
    dout = torch.randn(2, 12, 4, 16, generator=g)
    out = FlashAttentionFn.apply(q, k, v, window, softcap)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = attention_ref(q, k, v, window=window, softcap=softcap, scale=1.0)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    assert torch.equal(out, ref)
    kw = dict(window=window, softcap=softcap, scale=1.0)
    _, lse = attention_lse_ref(q.detach(), k.detach(), v.detach(), **kw)
    bounds = backward_error_bound(q.detach(), k.detach(), v.detach(),
                                  out.detach(), dout, lse, **kw)
    assert all(bool(((a.double() - c.double()).abs() <= b).all())
               for a, c, b in zip(got, want, bounds))


def test_rglru_scan_fn_against_autograd_through_plain():
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 9, 5, generator=g).requires_grad_()
    b = torch.randn(2, 9, 5, generator=g).requires_grad_()
    h0 = torch.randn(2, 5, generator=g).requires_grad_()
    w1, w2 = torch.randn(2, 9, 5, generator=g), torch.randn(2, 5, generator=g)
    hs, hl = RGLRUScanFn.apply(a, b, h0)
    got = torch.autograd.grad((hs * w1).sum() + (hl * w2).sum(), (a, b, h0))
    hs2, hl2 = rglru_scan_ref(a, b, h0)
    want = torch.autograd.grad((hs2 * w1).sum() + (hl2 * w2).sum(),
                               (a, b, h0))
    assert torch.equal(hs, hs2) and torch.equal(hl, hl2)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # only the sequence's grad, and only h_T's
    for wa, wb in ((w1, None), (None, w2)):
        hs, hl = RGLRUScanFn.apply(a, b, h0)
        hs2, hl2 = rglru_scan_ref(a, b, h0)
        pick = lambda s, l: (s * wa).sum() if wb is None else (l * wb).sum()
        got = torch.autograd.grad(pick(hs, hl), (a, b, h0))
        want = torch.autograd.grad(pick(hs2, hl2), (a, b, h0))
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_serving_stays_frozen_and_training_asks_for_grads():
    cfg = preg.get_config("qwen3-0.6b:smoke")
    pm = LM(cfg, device="cpu")
    assert not any(p.requires_grad for p in pm.parameters())
    b = _torch(_batch(cfg))
    # training asks for grads on a tree of the params layout
    _, _, grads = loss_and_grads(pm, pm.params(), b)
    assert all(g.abs().sum() > 0 for g in tr.leaves(grads))
    # ... and leaves the module's own params frozen, with no grads
    assert not any(p.requires_grad or p.grad is not None
                   for p in pm.parameters())
    logits, _ = pm.prefill({"tokens": b["tokens"]})
    assert not logits.requires_grad


def test_data_stream_matches_jax():
    for arch in ("qwen3-0.6b:smoke", "musicgen-medium:smoke",
                 "internvl2-26b:smoke"):
        cfg = preg.get_config(arch)
        kw = dict(seed=3, frontend=cfg.frontend, d_model=cfg.d_model,
                  n_patches=cfg.n_patches)
        a = SyntheticLMStream(cfg.vocab_size, 2, 40, **kw).make_batch(7)
        b = JaxStream(cfg.vocab_size, 2, 40, **kw).make_batch(7)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
