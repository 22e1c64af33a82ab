"""The LM on a (data, model) mesh of logical shards, on the CPU.

Against the reference: one module-scoped subprocess runs the JAX
package's own check of this half (``tests/test_distribution.py``'s
8-device recipe, ``--xla_force_host_platform_device_count=8``) on a
(data 2, model 4) mesh, executing three cells instead of compiling them:
qwen3-0.6b ``:smoke`` train, phi3.5-moe ``:smoke`` train (expert-parallel
MoE) and recurrentgemma-2b ``:smoke`` decode (ring cache, owner-local
writes; a 30-token prefill, then 4 decode steps across the ring's wrap).
Weights are numpy draws from a seed, written with the outputs to an
``.npz``. The port runs the same cells on 8 logical CPU shards
(``sharding.visible_devices`` named 8 times) and is held to:
  * ``LOSS_TOL`` (rtol 1e-5) on the loss, ce, aux and lr, rtol 1e-4 on the
    grad norm (``tests/test_torch_lm_train.py``'s tolerances);
  * the AdamW ``m`` within ``GRAD_REL`` (1e-4) of its largest magnitude
    (the first step's ``m`` is (1 - b1) g: the gradient bound), ``v``
    likewise, the step exactly;
  * the new params elementwise within ``ADAM_BOUND`` (:func:`adam_bound`):
    AdamW moves a weight by lr (F + wd p), F = m^ / (sqrt(v^) + eps), so
    two sides whose new ``m`` and ``v`` differ can be no closer than
    lr |F_got - F_want|, computed exactly from the two states, plus the
    roundings of the ops after them, counted below. F's slope in g is up
    to 1 / eps, so where |g| is near eps (1e-8) a rounding of g shows in
    the update: the params hold ``PARAM_ATOL`` = 1e-5 absolute at the
    ``:smoke`` widths (observed ~2e-6), not ``test_torch_lm_train.py``'s
    1e-6;
  * the decode logits and every cache leaf within 1e-5 absolute;
  * every output leaf's per-shard block equal to the JAX array's
    addressable-shard index, exactly (the stacked leaves' ``layers`` dim
    whole).

Against itself: a (1, 1) mesh equals ``mesh=None`` bit for bit (train,
prefill, decode); the MoE with ``model`` = 1 equals the dense path bit
for bit; (2, 4) against unsharded within ``PARAM_ATOL`` and ``LOSS_TOL``
under ``layout`` zero3 and tp and with 2 microbatches; the MoE sharded
against the dense path at a capacity that cannot drop; a checkpoint saved
on (2, 4) resumes on (4, 2) and on (1, 1). The options this file does not
run (``ctx``, heads that do not divide, ``seq_parallel``, RWKV-6 and the
frontends on ``model`` > 1) are ``test_torch_model_sharded_more.py``'s.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import LM as JaxLM
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.convert import (lm_cache_from_numpy, lm_params_from_numpy,
                                 lm_train_state_from_numpy)
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.distribution import collectives as col
from repro_torch.distribution import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM
from repro_torch.models import moe as pmoe
from repro_torch.train import optimizer as popt
from repro_torch.train import tree as tr
from repro_torch.train.checkpoint import Checkpointer

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
SERVE_ATOL = 1e-5
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
B, S = 8, 32                       # the train cells
DEC_B, DEC_S, PROMPT, DEC_STEPS = 8, 64, 30, 4
JAX_TIMEOUT_S = 300

JAX_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np, jax
    from repro import compat
    from repro.configs.base import ShapeConfig, ShardingConfig, TrainConfig
    from repro.configs.registry import get_config
    from repro.data.pipeline import SyntheticLMStream
    from repro.launch.steps import build_step
    from repro.train import optimizer as opt_lib

    mesh = compat.make_mesh(np.asarray(jax.devices()).reshape(2, 4),
                            ("data", "model"))
    pos = {{d: i for i, d in enumerate(mesh.devices.reshape(-1))}}
    out = {{}}
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    perf = ShardingConfig(remat_policy="none")

    def weights(specs, seed):
        rng = np.random.default_rng(seed)
        return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05
                                       ).astype(s.dtype), specs)

    def save(prefix, tree):
        for i, x in enumerate(jax.tree.leaves(tree)):
            out[f"{{prefix}}/{{i}}"] = np.asarray(x)
            idx = np.zeros((8, x.ndim, 2), np.int64)
            for d, ix in x.sharding.devices_indices_map(x.shape).items():
                for k, sl in enumerate(ix):
                    idx[pos[d], k] = (sl.start or 0, x.shape[k]
                                      if sl.stop is None else sl.stop)
            out[f"{{prefix}}_idx/{{i}}"] = idx

    for arch in ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch + ":smoke")
        shape = ShapeConfig("t", {S}, {B}, "train")
        fn, (pspecs, _, _), (psh, osh, bsh), _ = build_step(
            "train", cfg, shape, mesh, perf, tcfg)
        params = weights(pspecs, 1)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{arch}}/w/{{i}}"] = x
        batch = SyntheticLMStream(cfg.vocab_size, {B}, {S},
                                  seed=0).make_batch(0)
        with compat.set_mesh(mesh):
            p2, o2, met = fn(jax.device_put(params, psh),
                             jax.device_put(opt_lib.init(params), osh),
                             jax.device_put(batch, bsh))
        save(f"{{arch}}/params", p2)
        save(f"{{arch}}/opt", o2)
        for k, v in met.items():
            out[f"{{arch}}/met/{{k}}"] = np.asarray(v)

    arch = "recurrentgemma-2b"
    cfg = get_config(arch + ":smoke")
    shape = ShapeConfig("t", {DEC_S}, {DEC_B}, "decode")
    fn, (pspecs, _, _), (psh, bsh, csh), model = build_step(
        "decode", cfg, shape, mesh, perf)
    params = weights(pspecs, 2)
    for i, x in enumerate(jax.tree.leaves(params)):
        out[f"{{arch}}/w/{{i}}"] = x
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, ({DEC_B}, {PROMPT} + {DEC_STEPS})).astype(np.int32)
    _, cache = jax.jit(lambda p, t: model.prefill(
        p, {{"tokens": t}}, max_seq={DEC_S}))(params, toks[:, :{PROMPT}])
    for i, x in enumerate(jax.tree.leaves(cache)):
        out[f"{{arch}}/cache0/{{i}}"] = np.asarray(x)
    with compat.set_mesh(mesh):
        p = jax.device_put(params, psh)
        c = jax.device_put(cache, csh)
        for t in range({DEC_STEPS}):
            b = jax.device_put({{"tokens": toks[:, {PROMPT} + t:
                                              {PROMPT} + t + 1]}}, bsh)
            lg, c = fn(p, b, c)
            save(f"{{arch}}/logits{{t}}", lg)
    save(f"{{arch}}/cache", c)
    out[f"{{arch}}/tokens"] = toks
    np.savez({path!r}, **out)
    print("ok")
""")


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_cells") / "cells.npz")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = JAX_CELLS.format(src=os.path.abspath(src), path=path, B=B, S=S,
                            DEC_B=DEC_B, DEC_S=DEC_S, PROMPT=PROMPT,
                            DEC_STEPS=DEC_STEPS)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=JAX_TIMEOUT_S, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture
def logical(monkeypatch):
    """8 logical shards of the CPU."""
    monkeypatch.setattr(shd, "visible_devices",
                        lambda device: [torch.device("cpu")] * 8)
    return lambda shape: make_mesh(shape, device="cpu")


def _leaves(npz, prefix):
    out, i = [], 0
    while f"{prefix}/{i}" in npz:
        out.append(npz[f"{prefix}/{i}"])
        i += 1
    return out


def _jax_tree(like, leaves):
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _ids_port(jtree, pcfg, kind="params"):
    """The JAX leaf index of every leaf of the port layout."""
    ids = jax.tree.unflatten(
        jax.tree.structure(jtree),
        [np.full(np.shape(x)[:1] if np.ndim(x) else (), i)
         for i, x in enumerate(jax.tree.leaves(jtree))])
    # stacked leaves give each layer the id; unstacked ones keep theirs
    conv = lm_cache_from_numpy if kind == "cache" else lm_params_from_numpy
    return [int(t.reshape(-1)[0]) for t in tr.leaves(conv(ids, pcfg))]


def _check_blocks(npz, prefix, jtree, pcfg, port_shards, specs, mesh,
                  kind="params"):
    """Every port leaf's per-shard block against the JAX array's
    addressable-shard index of the same leaf, exactly."""
    ids = _ids_port(jtree, pcfg, kind)
    leaves = tr.leaves(port_shards[0])
    sl = shd.spec_leaves(specs)
    assert len(ids) == len(leaves) == len(sl)
    for k, (jid, spec) in enumerate(zip(ids, sl)):
        jidx = npz[f"{prefix}_idx/{jid}"]
        glob = list(leaves[k].shape)
        for d in range(len(glob)):
            p = spec[d] if d < len(spec) else None
            if p is not None:
                glob[d] *= shd.axis_size(mesh, p)
        if jidx.shape[1] == len(glob) + 1:         # a stacked leaf
            assert (jidx[:, 0, 0] == 0).all()
            jidx = jidx[:, 1:]
        for i in range(mesh.size):
            b = shd.block(glob, spec, mesh, i)
            got = [(s.start, s.stop) for s in b]
            assert got == [tuple(r) for r in jidx[i]], (k, i, spec)
            assert tuple(tr.leaves(port_shards[i])[k].shape) == \
                tuple(s.stop - s.start for s in b)


def adam_bound(p_old, got, want, lr, step, tcfg=TCFG):
    """``ADAM_BOUND`` per float32 param, float64: the gap two AdamW updates
    of ``p_old`` from the new states ``got`` and ``want`` (each ``(m,
    v)``) have in exact arithmetic, lr |F_got - F_want|, F = (m / c1) /
    (sqrt(v / c2) + eps) with the update's float32 c1, c2 and eps (the
    decay term lr wd p is the same on both sides), plus R, the two
    updates' roundings after the states. Counted per side, each rounding
    at most u (the unit roundoff, eps32 / 2) of its result: F's five ops
    (m / c1, v / c2 (half of it through the sqrt), sqrt, + eps, the
    division) 4.5 u |F|; wd p, + and lr * delta u (wd |p| + 2 |delta|)
    lr; p - lr delta u (|p| + lr |delta|); with |delta| <= |F| + wd |p|,
    a side's error is u (lr (7.5 |F| + 4 wd |p|) + |p|) to first order
    in u. R is the two sides', 7.5 rounded up to 8 for the second-order
    terms: eps32 (lr (8 max |F| + 4 wd |p|) + |p|)."""
    f32 = lambda x: float(np.float32(x))
    t = torch.tensor(float(step))
    c1 = float(1.0 - torch.pow(tcfg.beta1, t))
    c2 = float(1.0 - torch.pow(tcfg.beta2, t))
    eps, wd = f32(tcfg.eps), f32(tcfg.weight_decay)

    def F(m, v):
        return (m.double() / c1) / (torch.sqrt(v.double() / c2) + eps)

    fg, fw = F(*got), F(*want)
    p = p_old.double().abs()
    return lr * (fg - fw).abs() + torch.finfo(torch.float32).eps * (
        lr * (8 * torch.maximum(fg.abs(), fw.abs()) + 4 * wd * p) + p)


def adam_bound_ok(p_got, p_want, p_old, o_got, o_want, lr, tcfg=TCFG):
    """Every new param within :func:`adam_bound` of the other side's;
    ``o_*`` the new AdamW states."""
    step = int(o_want["step"])
    return all(bool(((pg.double() - pw.double()).abs() <= adam_bound(
        po, (mg, vg), (mw, vw), lr, step, tcfg)).all())
               for pg, pw, po, mg, mw, vg, vw in zip(
                   tr.leaves(p_got), tr.leaves(p_want), tr.leaves(p_old),
                   tr.leaves(o_got["m"]), tr.leaves(o_want["m"]),
                   tr.leaves(o_got["v"]), tr.leaves(o_want["v"])))


def _close_trees(got, want, atol):
    for a, b in zip(tr.leaves(got), tr.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0,
                        atol=atol)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"],
                         ids=["qwen3", "phi3.5-moe"])
def test_train_cell_matches_reference_on_2x4(jax_cells, logical, arch):
    jcfg = jreg.get_config(arch + ":smoke")
    pcfg = preg.get_config(arch + ":smoke")
    jm = JaxLM(jcfg)
    jp = _jax_tree(jm.param_specs(), _leaves(jax_cells, f"{arch}/w"))
    params = lm_params_from_numpy(jp, pcfg)
    mesh = logical((2, 4))
    step, model = psteps.build_train_step(
        pcfg, ShapeConfig("t", S, B, "train"), TCFG, mesh=mesh,
        perf=ShardingConfig())
    lay = step.layouts
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMStream(
        pcfg.vocab_size, B, S, seed=0).make_batch(0).items()}
    new_p, new_o, met = step(shd.place_tree(params, lay["params"], mesh),
                             psteps.init_opt_state(params, mesh, lay),
                             shd.place_tree(batch, lay["batch"](batch),
                                            mesh))
    for k in ("loss", "ce", "aux", "lr"):
        assert_allclose(float(met[k]), float(jax_cells[f"{arch}/met/{k}"]),
                        **LOSS_TOL)
    assert_allclose(float(met["grad_norm"]),
                    float(jax_cells[f"{arch}/met/grad_norm"]), rtol=1e-4)
    want_p = lm_params_from_numpy(
        _jax_tree(jp, _leaves(jax_cells, f"{arch}/params")), pcfg)
    got_p = shd.gather_tree(new_p, lay["params"], mesh)
    _close_trees(got_p, want_p, PARAM_ATOL)
    jo = {"m": jp, "v": jp, "step": np.zeros((), np.int32)}
    want_o = lm_train_state_from_numpy(
        _jax_tree(jo, _leaves(jax_cells, f"{arch}/opt")), pcfg)
    got_o = shd.gather_tree(new_o, lay["opt"], mesh)
    assert adam_bound_ok(got_p, want_p, params, got_o, want_o,
                         float(met["lr"]))
    for key in ("m", "v"):
        for a, b in zip(tr.leaves(got_o[key]), tr.leaves(want_o[key])):
            scale = max(float(b.abs().max()), 1e-30)
            assert_allclose(a.numpy(), b.numpy(), rtol=0,
                            atol=GRAD_REL * scale)
    assert torch.equal(got_o["step"], want_o["step"])
    _check_blocks(jax_cells, f"{arch}/params", jp, pcfg, new_p,
                  lay["params"], mesh)
    for key in ("m", "v"):
        # the opt leaves follow the params' in the JAX order: m, step, v
        off = 0 if key == "m" else len(jax.tree.leaves(jp)) + 1
        npz = {f"x_idx/{i}": jax_cells[f"{arch}/opt_idx/{i + off}"]
               for i in range(len(jax.tree.leaves(jp)))}
        _check_blocks(npz, "x", jp, pcfg, [o[key] for o in new_o],
                      lay["opt"][key], mesh)


def test_decode_cell_matches_reference_on_2x4(jax_cells, logical):
    arch = "recurrentgemma-2b"
    jcfg = jreg.get_config(arch + ":smoke")
    pcfg = preg.get_config(arch + ":smoke")
    jm = JaxLM(jcfg)
    jp = _jax_tree(jm.param_specs(), _leaves(jax_cells, f"{arch}/w"))
    jc_like = jm.cache_specs(DEC_B, DEC_S)
    params = lm_params_from_numpy(jp, pcfg)
    cache0 = lm_cache_from_numpy(
        _jax_tree(jc_like, _leaves(jax_cells, f"{arch}/cache0")), pcfg)
    mesh = logical((2, 4))
    step, model = psteps.build_decode_step(
        pcfg, ShapeConfig("t", DEC_S, DEC_B, "decode"), mesh,
        ShardingConfig())
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    cs = shd.place_tree(cache0, lay["cache"], mesh)
    toks = torch.from_numpy(jax_cells[f"{arch}/tokens"])
    for t in range(DEC_STEPS):
        b = {"tokens": toks[:, PROMPT + t:PROMPT + t + 1]}
        lgs, cs = step(ps, shd.place_tree(b, lay["batch"](b), mesh), cs)
        want = jax_cells[f"{arch}/logits{t}/0"]
        got = shd.gather_tree(lgs, [lay["logits"]], mesh)
        assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_ATOL)
        idx = jax_cells[f"{arch}/logits{t}_idx/0"]
        for i in range(mesh.size):
            blk = shd.block(want.shape, lay["logits"], mesh, i)
            assert [(s.start, s.stop) for s in blk] == \
                [tuple(r) for r in idx[i]]
    want_c = lm_cache_from_numpy(
        _jax_tree(jc_like, _leaves(jax_cells, f"{arch}/cache")), pcfg)
    got_c = shd.gather_tree(cs, lay["cache"], mesh)
    assert torch.equal(got_c["lengths"], want_c["lengths"])
    _close_trees(got_c, want_c, SERVE_ATOL)
    _check_blocks(jax_cells, f"{arch}/cache", jc_like, pcfg, cs,
                  lay["cache"], mesh, kind="cache")


# --------------------------------------------------------------------------
# The port against itself
# --------------------------------------------------------------------------

def _setup(arch, overrides=None, batch=B, seq=S):
    cfg = preg.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = LM(cfg, device="cpu", seed=1)
    params = tr.map_(lambda x: x.detach(), model.params())
    b = {k: torch.from_numpy(v) for k, v in SyntheticLMStream(
        cfg.vocab_size, batch, seq, seed=0).make_batch(0).items()}
    return cfg, params, b


def _sharded_step(cfg, params, b, mesh, perf=ShardingConfig(), tcfg=TCFG):
    step, model = psteps.build_train_step(
        cfg, ShapeConfig("t", b["tokens"].shape[1], b["tokens"].shape[0],
                         "train"), tcfg, mesh=mesh, perf=perf)
    lay = step.layouts
    new_p, new_o, met = step(shd.place_tree(params, lay["params"], mesh),
                             psteps.init_opt_state(params, mesh, lay),
                             shd.place_tree(b, lay["batch"](b), mesh))
    return (shd.gather_tree(new_p, lay["params"], mesh),
            shd.gather_tree(new_o, lay["opt"], mesh), met)


def _plain_step(cfg, params, b, tcfg=TCFG):
    step, _ = psteps.build_train_step(
        cfg, ShapeConfig("t", b["tokens"].shape[1], b["tokens"].shape[0],
                         "train"), tcfg, "cpu")
    return step(params, popt.init(params), b)


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tr.leaves(a), tr.leaves(b)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b:smoke",
                                  "recurrentgemma-2b:smoke",
                                  "phi3.5-moe-42b-a6.6b:smoke"],
                         ids=["qwen3", "recurrentgemma", "phi3.5-moe"])
def test_one_by_one_mesh_is_unsharded_bit_for_bit(arch):
    cfg, params, b = _setup(arch)
    mesh = make_mesh((1, 1), devices=["cpu"])
    got = _sharded_step(cfg, params, b, mesh)
    want = _plain_step(cfg, params, b)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])
    # serving: prefill then decode steps
    sstep, sm = psteps.build_decode_step(cfg, ShapeConfig("d", S, 4,
                                                          "decode"), mesh)
    plain = LM(cfg, device="cpu", params=params)
    sm.load_params(params)
    ps = sm.shard_params()
    tok = b["tokens"][:4]
    lg_a, c_a = plain.prefill({"tokens": tok[:, :20]}, max_seq=S)
    lg_b, c_b = sm.prefill(({"tokens": tok[:, :20]},), max_seq=S, params=ps)
    assert torch.equal(lg_a, lg_b[0]) and _bits_equal(c_a, c_b[0])
    for t in range(20, 24):
        lg_a, c_a = plain.decode_step({"tokens": tok[:, t:t + 1]}, c_a)
        lg_b, c_b = sstep(ps, ({"tokens": tok[:, t:t + 1]},), c_b)
        assert torch.equal(lg_a, lg_b[0]) and _bits_equal(c_a, c_b[0])


@pytest.mark.parametrize("layout,micro", [("zero3", 1), ("tp", 1),
                                          ("zero3", 2)],
                         ids=["zero3", "tp", "zero3-micro2"])
def test_2x4_against_unsharded(logical, layout, micro):
    cfg, params, b = _setup("qwen3-0.6b:smoke")
    tcfg = dataclasses.replace(TCFG, microbatches=micro)
    got = _sharded_step(cfg, params, b, logical((2, 4)),
                        ShardingConfig(layout=layout), tcfg)
    want = _plain_step(cfg, params, b, tcfg)
    for k in ("loss", "ce", "lr"):
        assert_allclose(float(got[2][k]), float(want[2][k]), **LOSS_TOL)
    assert_allclose(float(got[2]["grad_norm"]), float(want[2]["grad_norm"]),
                    rtol=1e-4)
    for a, c in zip(tr.leaves(got[1]["m"]), tr.leaves(want[1]["m"])):
        assert_allclose(a.numpy(), c.numpy(), rtol=0,
                        atol=GRAD_REL * max(float(c.abs().max()), 1e-30))
    _close_trees(got[0], want[0], PARAM_ATOL)
    assert adam_bound_ok(got[0], want[0], params, got[1], want[1],
                         float(want[2]["lr"]), tcfg)


def test_two_sharded_steps_are_bit_equal(logical):
    cfg, params, b = _setup("recurrentgemma-2b:smoke")
    mesh = logical((2, 2))
    one = _sharded_step(cfg, params, b, mesh)
    two = _sharded_step(cfg, params, b, mesh)
    assert _bits_equal(one[0], two[0]) and _bits_equal(one[1], two[1])


def test_psum_and_gather_calls_counted(logical):
    cfg, params, b = _setup("qwen3-0.6b:smoke")
    for k in col.CALLS:
        col.CALLS[k] = 0
    _sharded_step(cfg, params, b, logical((2, 4)))
    # per layer: the attention and MLP outputs' psums, forward; the norm
    # weights' and the kv projections' gathers (the 2 kv heads do not
    # split 4 ways)
    assert col.CALLS["psum"] >= 2 * cfg.n_layers * 2
    assert col.CALLS["all_gather"] > 0


def test_moe_model_one_is_dense_bit_for_bit():
    cfg = preg.get_config("phi3.5-moe-42b-a6.6b:smoke")
    from repro_torch.models import param as Pm
    g = torch.Generator().manual_seed(0)
    p = Pm.init(pmoe.moe_defs(cfg), g, "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=g)
    dense = pmoe.moe_apply(p, x, cfg)
    for shape in ((1, 1), (2, 1)):
        mesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
        out = pmoe.moe_apply(p, x, cfg, shard=(mesh, ("pod", "data")))
        assert torch.equal(out[0], dense[0]) and torch.equal(out[1],
                                                             dense[1])


def test_moe_sharded_against_dense_without_drops(logical):
    cfg = preg.get_config("phi3.5-moe-42b-a6.6b:smoke")
    # a capacity of every token: nothing drops on either path
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    from repro_torch.models import param as Pm
    g = torch.Generator().manual_seed(0)
    p = Pm.init(pmoe.moe_defs(cfg), g, "cpu")
    x = torch.randn((4, 8, cfg.d_model), generator=g)
    dense, aux_d = pmoe.moe_apply(p, x, cfg)
    counts = []
    out, aux = pmoe.moe_apply(p, x, cfg, counts=counts,
                              shard=(logical((2, 4)), ("pod", "data")))
    assert sum(int(c[0]) for c in counts) == 0
    assert sum(int(c[1]) for c in counts) == \
        x.shape[0] * x.shape[1] * cfg.moe.experts_per_token
    assert_allclose(out.numpy(), dense.numpy(), rtol=0, atol=1e-6)
    # the aux loss: the mean of the data shards' (their own densities)
    assert abs(float(aux) - float(aux_d)) < 0.05 * float(aux_d)


def test_checkpoint_on_2x4_resumes_on_4x2_and_1x1(logical, tmp_path):
    from repro_torch.train.loop import train
    cfg = preg.get_config("qwen3-0.6b:smoke")
    shape = ShapeConfig("t", 16, 8, "train")

    def tcfg(d):
        return TrainConfig(total_steps=4, checkpoint_every=2,
                           checkpoint_dir=str(d), async_checkpoint=False,
                           warmup_steps=1, learning_rate=1e-3)

    straight = train(cfg, shape, logical((2, 4)), tcfg=tcfg(tmp_path / "s"))
    for other in ((4, 2), (1, 1)):
        d = tmp_path / f"r{other[0]}"
        train(cfg, shape, logical((2, 4)), tcfg=tcfg(d), max_steps=2)
        resumed = train(cfg, shape, logical(other), tcfg=tcfg(d))
        assert resumed.restored_from == 2 and resumed.steps_run == 2
        assert_allclose(resumed.losses, straight.losses[2:], **LOSS_TOL)
    # the saved leaves are global tensors: a one-device restore takes them
    ck = Checkpointer(str(tmp_path / "r4"), async_mode=False)
    params = LM(cfg, device="cpu").params()
    like = (params, popt.init(params))
    (p, o), extra = ck.restore(ck.latest_step(), like)
    assert tr.leaves(p)[0].shape == tr.leaves(params)[0].shape


@pytest.mark.parametrize("arch,shape,cache_seq", [
    ("qwen3-0.6b:smoke", (2, 4), True),        # the cache's slots split
    ("qwen3-0.6b:smoke", (2, 2), False),       # its kv heads split
    ("qwen3-0.6b:smoke", (2, 4), False),       # 2 kv heads: whole on each
    ("recurrentgemma-2b:smoke", (2, 4), True),  # ring cache, RG-LRU
    ("gemma2-2b:smoke", (2, 2), True),         # softcaps, local + global
], ids=["qwen3-slots", "qwen3-kv-heads", "qwen3-replicated",
        "recurrentgemma-ring", "gemma2"])
def test_prefill_and_decode_against_unsharded(logical, arch, shape,
                                              cache_seq):
    """Prefill 24 tokens into a 32-slot cache, then 8 decode steps (past
    the ring's wrap): every step's logits and the final cache within
    ``SERVE_ATOL`` of the unsharded model's, each cache layout the
    planner gives."""
    cfg, params, b = _setup(arch)
    tok = b["tokens"][:4]
    plain = LM(cfg, device="cpu", params=params)
    mesh = logical(shape)
    step, model = psteps.build_decode_step(
        cfg, ShapeConfig("d", S, 4, "decode"), mesh,
        ShardingConfig(shard_cache_seq=cache_seq))
    model.load_params(params)
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    head = {"tokens": tok[:, :24]}
    lg_a, c_a = plain.prefill(head, max_seq=S)
    lg_b, c_b = model.prefill(shd.place_tree(head, lay["batch"](head),
                                             mesh), max_seq=S, params=ps)
    for t in range(24, S):
        got = shd.gather_tree(lg_b, [lay["logits"]], mesh)
        assert_allclose(got.numpy(), lg_a.numpy(), rtol=0, atol=SERVE_ATOL)
        inp = {"tokens": tok[:, t:t + 1]}
        lg_a, c_a = plain.decode_step(inp, c_a)
        lg_b, c_b = step(ps, shd.place_tree(inp, lay["batch"](inp), mesh),
                         c_b)
    _close_trees(shd.gather_tree(c_b, lay["cache"], mesh), c_a, SERVE_ATOL)


def test_embed_on_d_model_against_unsharded(logical):
    """``embed_shard="d_model"``: the tables split on d_model (the
    lookup gathers its columns, the head is gathered whole), the step
    as the vocab-parallel one."""
    cfg, params, b = _setup("qwen3-0.6b:smoke")
    perf = ShardingConfig(embed_shard="d_model")
    mesh = logical((2, 4))
    got = _sharded_step(cfg, params, b, mesh, perf)
    want = _plain_step(cfg, params, b)
    assert LM(cfg, mesh=mesh, perf=perf).param_specs()["embed"]["table"] \
        == (None, "model")
    for k in ("loss", "ce", "lr"):
        assert_allclose(float(got[2][k]), float(want[2][k]), **LOSS_TOL)
    assert adam_bound_ok(got[0], want[0], params, got[1], want[1],
                         float(want[2]["lr"]))
