"""The rest of model sharding on a mesh of logical shards, on the CPU:
context-parallel attention (``attn_sharding="ctx"``, and ``auto`` where
the heads do not divide ``model``), ``heads`` mode with heads that do not
divide, ``seq_parallel``, the RWKV-6 block and the ``embeddings`` and
``vlm`` frontends with ``model`` > 1.

The tests are split over three files so that a run with one worker a
file spreads them: this one (qwen3's reference cells, the options against
the same mesh, ctx's edge cases, the flash offsets), ``..._cells.py`` (the
other families' reference cells, prefill and decode against
``mesh=None``) and ``..._twins.py`` (train steps against ``mesh=None``);
the cells, the JAX script and the shared helpers live here.

Against the reference: a module-scoped subprocess per file runs the JAX
package's own steps (``launch.steps.build_step``) on 8 forced CPU devices
(``--xla_force_host_platform_device_count=8``) for that file's cells
(``CELLS``: ten in all), executing
them: qwen3-0.6b train on (2, 4) with ``ctx``, with ``seq_parallel`` and
on (1, 8) with ``heads`` (4 heads over 8); recurrentgemma-2b on (1, 8),
``auto`` picking ``ctx``, train and decode; rwkv6-1.6b on (2, 4), train
and decode; musicgen-medium (frames) train and internvl2-26b (patches)
train and prefill on (2, 4); all ``:smoke`` configs at B = 8, S = 32.
Weights and inputs are numpy draws from a seed, written with the outputs
to an ``.npz``; a decode cell is a 30-token prefill into a 64-slot cache,
then 4 steps across the local ring's wrap. The port runs the same cells
on 8 logical CPU shards and is held to ``test_torch_model_sharded_steps``'s
bounds: ``LOSS_TOL`` on the loss, ce, aux and lr, rtol 1e-4 on the grad
norm, ``GRAD_REL`` on AdamW's ``m`` and ``v``, ``ADAM_BOUND`` on the
params, ``SERVE_ATOL`` on the logits and every cache leaf, and every
output leaf's per-shard block equal to the JAX array's addressable-shard
index.

Against itself: each option on (2, 4) and (1, 8) against ``mesh=None``
(train within the same bounds, prefill and decode steps within
``SERVE_ATOL``), ``ctx`` with S % m != 0 (S = 30 on m = 4) and with
S < m (S = 3 on m = 4: shards with no rows launch nothing); the flash
kernel's plain version at a query offset against the rows of the whole
pass, and ``FlashAttentionFn``'s gradients (the chunked plain backward on
the CPU) at an offset against autograd through the whole plain pass; ``all_to_all`` and its backward against
their definition.
"""
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
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.convert import (lm_cache_from_numpy, lm_params_from_numpy,
                                 lm_train_state_from_numpy)
from repro_torch.distribution import collectives as col
from repro_torch.distribution import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import steps as psteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM
from repro_torch.models.layers import FlashAttentionFn
from repro_torch.train import optimizer as popt
from repro_torch.train import tree as tr
from test_torch_model_sharded_steps import (GRAD_REL, LOSS_TOL, PARAM_ATOL,
                                            SERVE_ATOL, TCFG, _check_blocks,
                                            _close_trees, _jax_tree, _leaves,
                                            adam_bound_ok)

B, S = 8, 32
DEC_B, DEC_S, PROMPT, DEC_STEPS = 8, 64, 30, 4
JAX_TIMEOUT_S = 400

# key, arch, mesh, step, ShardingConfig options
CELLS = [
    ("qwen3-ctx", "qwen3-0.6b", (2, 4), "train",
     {"attn_sharding": "ctx"}),
    ("rg-auto", "recurrentgemma-2b", (1, 8), "train", {}),
    ("rg-decode", "recurrentgemma-2b", (1, 8), "decode", {}),
    ("qwen3-heads", "qwen3-0.6b", (1, 8), "train",
     {"attn_sharding": "heads"}),
    ("qwen3-sp", "qwen3-0.6b", (2, 4), "train", {"seq_parallel": True}),
    ("rwkv-train", "rwkv6-1.6b", (2, 4), "train", {}),
    ("rwkv-decode", "rwkv6-1.6b", (2, 4), "decode", {}),
    ("music-train", "musicgen-medium", (2, 4), "train", {}),
    ("vlm-train", "internvl2-26b", (2, 4), "train", {}),
    ("vlm-prefill", "internvl2-26b", (2, 4), "prefill", {}),
]

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

    out = {{}}
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)

    def weights(specs, seed):
        rng = np.random.default_rng(seed)
        return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05
                                       ).astype(s.dtype), specs)

    def batch_of(cfg, kind, b, s, seed):
        rng = np.random.default_rng(seed)
        d = cfg.d_model
        if cfg.frontend == "embeddings":
            x = {{"frames": rng.standard_normal((b, s, d)).astype(
                np.float32)}}
        elif cfg.frontend == "vlm":
            x = {{"tokens": rng.integers(0, cfg.vocab_size,
                                         (b, s - cfg.n_patches)).astype(
                                             np.int32),
                  "patches": rng.standard_normal(
                      (b, cfg.n_patches, d)).astype(np.float32)}}
        else:
            x = SyntheticLMStream(cfg.vocab_size, b, s,
                                  seed=seed).make_batch(0)
            x = {{"tokens": x["tokens"]}}
        if kind == "train":
            n = s - (cfg.n_patches if cfg.frontend == "vlm" else 0)
            x["targets"] = rng.integers(0, cfg.vocab_size, (b, n)).astype(
                np.int32)
        return x

    for key, arch, shape, kind, opts in {cells!r}:
        mesh = compat.make_mesh(np.asarray(jax.devices()).reshape(*shape),
                                ("data", "model"))
        pos = {{d: i for i, d in enumerate(mesh.devices.reshape(-1))}}

        def save(prefix, tree):
            for i, x in enumerate(jax.tree.leaves(tree)):
                out[f"{{prefix}}/{{i}}"] = np.asarray(x)
                idx = np.zeros((8, x.ndim, 2), np.int64)
                for d, ix in x.sharding.devices_indices_map(x.shape).items():
                    for k, sl in enumerate(ix):
                        idx[pos[d], k] = (sl.start or 0, x.shape[k]
                                          if sl.stop is None else sl.stop)
                out[f"{{prefix}}_idx/{{i}}"] = idx

        cfg = get_config(arch + ":smoke")
        perf = ShardingConfig(remat_policy="none", **opts)
        seq, b = ({S}, {B}) if kind != "decode" else ({DEC_S}, {DEC_B})
        fn, specs, shs, model = build_step(
            kind, cfg, ShapeConfig("t", seq, b, kind), mesh, perf, tcfg)
        params = weights(specs[0], 3)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{{key}}/w/{{i}}"] = x
        if kind == "decode":
            toks = np.random.default_rng(4).integers(
                0, cfg.vocab_size, ({DEC_B}, {PROMPT} + {DEC_STEPS})).astype(
                    np.int32)
            out[f"{{key}}/tokens"] = toks
            _, cache = jax.jit(lambda p, t: model.prefill(
                p, {{"tokens": t}}, max_seq={DEC_S}))(params,
                                                      toks[:, :{PROMPT}])
            for i, x in enumerate(jax.tree.leaves(cache)):
                out[f"{{key}}/cache0/{{i}}"] = np.asarray(x)
            psh, bsh, csh = shs
            with compat.set_mesh(mesh):
                p = jax.device_put(params, psh)
                c = jax.device_put(cache, csh)
                for t in range({DEC_STEPS}):
                    x = jax.device_put({{"tokens": toks[
                        :, {PROMPT} + t:{PROMPT} + t + 1]}}, bsh)
                    lg, c = fn(p, x, c)
                    save(f"{{key}}/logits{{t}}", lg)
            save(f"{{key}}/cache", c)
            continue
        batch = batch_of(cfg, kind, b, seq, 5)
        for k, v in batch.items():
            out[f"{{key}}/batch/{{k}}"] = v
        with compat.set_mesh(mesh):
            if kind == "train":
                psh, osh, bsh = shs
                p2, o2, met = fn(jax.device_put(params, psh),
                                 jax.device_put(opt_lib.init(params), osh),
                                 jax.device_put(batch, bsh))
                save(f"{{key}}/params", p2)
                save(f"{{key}}/opt", o2)
                for k, v in met.items():
                    out[f"{{key}}/met/{{k}}"] = np.asarray(v)
            else:
                psh, bsh = shs
                lg, cache = fn(jax.device_put(params, psh),
                               jax.device_put(batch, bsh))
                save(f"{{key}}/logits", lg)
                save(f"{{key}}/cache", cache)
    np.savez({path!r}, **out)
    print("ok")
""")


def run_jax_cells(tmp_path_factory, keys):
    """The reference's outputs for the cells named in ``keys``, from one
    JAX subprocess on 8 forced CPU devices (each file of these tests runs
    only its own cells)."""
    path = str(tmp_path_factory.mktemp("jax_more") / "cells.npz")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = JAX_CELLS.format(src=os.path.abspath(src), path=path, B=B, S=S,
                            DEC_B=DEC_B, DEC_S=DEC_S, PROMPT=PROMPT,
                            DEC_STEPS=DEC_STEPS,
                            cells=[c for c in CELLS if c[0] in keys])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=JAX_TIMEOUT_S, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


# this file's reference cells: qwen3-0.6b's options
QWEN_CELLS = ("qwen3-ctx", "qwen3-heads", "qwen3-sp")


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    return run_jax_cells(tmp_path_factory, QWEN_CELLS)


@pytest.fixture
def logical(monkeypatch):
    """8 logical shards of the CPU."""
    monkeypatch.setattr(shd, "visible_devices",
                        lambda device: [torch.device("cpu")] * 8)
    return lambda shape: make_mesh(shape, device="cpu")


def _cell(key):
    return next(c for c in CELLS if c[0] == key)


def _jax_params(jax_cells, key, arch):
    jm = JaxLM(jreg.get_config(arch + ":smoke"))
    jp = _jax_tree(jm.param_specs(), _leaves(jax_cells, f"{key}/w"))
    return jm, jp


def _npz_batch(jax_cells, key):
    pre = f"{key}/batch/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in jax_cells.items()
            if k.startswith(pre)}


def check_train_cell(jax_cells, logical, key):
    """A train cell's step on 8 logical shards against the reference's."""
    _, arch, shape, _, opts = _cell(key)
    pcfg = preg.get_config(arch + ":smoke")
    _, jp = _jax_params(jax_cells, key, arch)
    params = lm_params_from_numpy(jp, pcfg)
    batch = _npz_batch(jax_cells, key)
    mesh = logical(shape)
    step, _ = psteps.build_train_step(
        pcfg, ShapeConfig("t", S, B, "train"), TCFG, mesh=mesh,
        perf=ShardingConfig(**opts))
    lay = step.layouts
    new_p, new_o, met = step(shd.place_tree(params, lay["params"], mesh),
                             psteps.init_opt_state(params, mesh, lay),
                             shd.place_tree(batch, lay["batch"](batch),
                                            mesh))
    for k in ("loss", "ce", "aux", "lr"):
        assert_allclose(float(met[k]), float(jax_cells[f"{key}/met/{k}"]),
                        **LOSS_TOL)
    assert_allclose(float(met["grad_norm"]),
                    float(jax_cells[f"{key}/met/grad_norm"]), rtol=1e-4)
    want_p = lm_params_from_numpy(
        _jax_tree(jp, _leaves(jax_cells, f"{key}/params")), pcfg)
    got_p = shd.gather_tree(new_p, lay["params"], mesh)
    jo = {"m": jp, "v": jp, "step": np.zeros((), np.int32)}
    want_o = lm_train_state_from_numpy(
        _jax_tree(jo, _leaves(jax_cells, f"{key}/opt")), pcfg)
    got_o = shd.gather_tree(new_o, lay["opt"], mesh)
    assert adam_bound_ok(got_p, want_p, params, got_o, want_o,
                         float(met["lr"]))
    for k in ("m", "v"):
        for a, b in zip(tr.leaves(got_o[k]), tr.leaves(want_o[k])):
            scale = max(float(b.abs().max()), 1e-30)
            assert_allclose(a.numpy(), b.numpy(), rtol=0,
                            atol=GRAD_REL * scale)
    assert torch.equal(got_o["step"], want_o["step"])
    _check_blocks(jax_cells, f"{key}/params", jp, pcfg, new_p,
                  lay["params"], mesh)
    for k in ("m", "v"):
        # the opt leaves follow the params' in the JAX order: m, step, v
        off = 0 if k == "m" else len(jax.tree.leaves(jp)) + 1
        npz = {f"x_idx/{i}": jax_cells[f"{key}/opt_idx/{i + off}"]
               for i in range(len(jax.tree.leaves(jp)))}
        _check_blocks(npz, "x", jp, pcfg, [o[k] for o in new_o],
                      lay["opt"][k], mesh)


def _check_logits(jax_cells, prefix, lgs, spec, mesh):
    want = jax_cells[f"{prefix}/0"]
    got = shd.gather_tree(lgs, [spec], mesh)
    assert_allclose(got.numpy(), want, rtol=0, atol=SERVE_ATOL)
    idx = jax_cells[f"{prefix}_idx/0"]
    for i in range(mesh.size):
        blk = shd.block(want.shape, spec, mesh, i)
        assert [(s.start, s.stop) for s in blk] == [tuple(r) for r in idx[i]]


def _check_cache(jax_cells, prefix, jc_like, pcfg, cs, spec, mesh):
    want = lm_cache_from_numpy(_jax_tree(jc_like, _leaves(jax_cells,
                                                          prefix)), pcfg)
    got = shd.gather_tree(cs, spec, mesh)
    assert torch.equal(got["lengths"], want["lengths"])
    _close_trees(got, want, SERVE_ATOL)
    _check_blocks(jax_cells, prefix, jc_like, pcfg, cs, spec, mesh,
                  kind="cache")


def check_decode_cell(jax_cells, logical, key):
    """A decode cell's 4 steps on 8 logical shards against the
    reference's."""
    _, arch, shape, _, opts = _cell(key)
    pcfg = preg.get_config(arch + ":smoke")
    jm, jp = _jax_params(jax_cells, key, arch)
    jc_like = jm.cache_specs(DEC_B, DEC_S)
    params = lm_params_from_numpy(jp, pcfg)
    cache0 = lm_cache_from_numpy(
        _jax_tree(jc_like, _leaves(jax_cells, f"{key}/cache0")), pcfg)
    mesh = logical(shape)
    step, _ = psteps.build_decode_step(
        pcfg, ShapeConfig("t", DEC_S, DEC_B, "decode"), mesh,
        ShardingConfig(**opts))
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    cs = shd.place_tree(cache0, lay["cache"], mesh)
    toks = torch.from_numpy(jax_cells[f"{key}/tokens"])
    for t in range(DEC_STEPS):
        b = {"tokens": toks[:, PROMPT + t:PROMPT + t + 1]}
        lgs, cs = step(ps, shd.place_tree(b, lay["batch"](b), mesh), cs)
        _check_logits(jax_cells, f"{key}/logits{t}", lgs, lay["logits"],
                      mesh)
    _check_cache(jax_cells, f"{key}/cache", jc_like, pcfg, cs, lay["cache"],
                 mesh)


def check_prefill_cell(jax_cells, logical, key):
    """A prefill cell on 8 logical shards against the reference's."""
    _, arch, shape, _, opts = _cell(key)
    pcfg = preg.get_config(arch + ":smoke")
    jm, jp = _jax_params(jax_cells, key, arch)
    params = lm_params_from_numpy(jp, pcfg)
    batch = _npz_batch(jax_cells, key)
    mesh = logical(shape)
    step, _ = psteps.build_prefill_step(
        pcfg, ShapeConfig("t", S, B, "prefill"), mesh,
        ShardingConfig(**opts))
    lay = step.layouts
    lgs, cs = step(shd.place_tree(params, lay["params"], mesh),
                   shd.place_tree(batch, lay["batch"](batch), mesh))
    _check_logits(jax_cells, f"{key}/logits", lgs, lay["logits"], mesh)
    _check_cache(jax_cells, f"{key}/cache", jm.cache_specs(B, S), pcfg, cs,
                 lay["cache"], mesh)


@pytest.mark.parametrize("key", QWEN_CELLS)
def test_train_cell_matches_reference(jax_cells, logical, key):
    check_train_cell(jax_cells, logical, key)


# --------------------------------------------------------------------------
# The port against itself
# --------------------------------------------------------------------------

def _inputs(cfg, b, s, seed=0):
    """A train batch of ``cfg``'s frontend, numpy draws from ``seed``:
    ``s`` positions in all (``vlm``: patches first, then tokens)."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    if cfg.frontend == "embeddings":
        return {"frames": f(b, s, cfg.d_model), "targets": t(b, s)}
    if cfg.frontend == "vlm":
        n = s - cfg.n_patches
        return {"tokens": t(b, n), "patches": f(b, cfg.n_patches,
                                                 cfg.d_model),
                "targets": t(b, n)}
    return {"tokens": t(b, s), "targets": t(b, s)}


def _params(cfg):
    return tr.map_(lambda x: x.detach(), LM(cfg, device="cpu",
                                             seed=1).params())


TWINS = {
    "ctx": ("qwen3-0.6b", {"attn_sharding": "ctx"}),
    "auto-ctx": ("recurrentgemma-2b", {}),
    "heads-split": ("qwen3-0.6b", {"attn_sharding": "heads"}),
    "seq_parallel": ("qwen3-0.6b", {"seq_parallel": True}),
    "sp-ctx-gemma2": ("gemma2-2b", {"seq_parallel": True,
                                    "attn_sharding": "ctx"}),
    "sp-rglru": ("recurrentgemma-2b", {"seq_parallel": True}),
    "rwkv": ("rwkv6-1.6b", {}),
    "rwkv-chunked-sp": ("rwkv6-1.6b", {"rwkv_chunk": 8,
                                       "seq_parallel": True}),
    "embeddings": ("musicgen-medium", {}),
    "vlm": ("internvl2-26b", {}),
}


@pytest.mark.parametrize("arch,shape,size", [
    ("qwen3-0.6b", (2, 4), 30),        # 2 kv heads: the cache whole
    ("qwen3-0.6b", (2, 2), 31),        # 2 kv heads over 2: split on them
    ("musicgen-medium", (2, 4), 30),   # 4 kv heads over 4: split on them
    ("recurrentgemma-2b", (1, 8), 30),  # a ring, 1 kv head
], ids=["qwen3-whole", "qwen3-kv-heads", "musicgen", "recurrentgemma"])
def test_decode_with_a_cache_size_model_does_not_divide(logical, arch,
                                                         shape, size):
    """A cache of 30 or 31 slots on ``model`` = 2, 4 or 8: its slots
    cannot split, so its blocks are whole on them (or split on the kv
    heads), and a block's shape alone does not say which (a 30-slot block
    is also a quarter of 120 slots): the decode step reads the layout at
    ``max_seq``. Every step's logits and the final cache within
    ``SERVE_ATOL`` of the unsharded model's; without ``max_seq`` a mesh
    decode step raises."""
    cfg = preg.get_config(arch + ":smoke")
    params = _params(cfg)
    b = _inputs(cfg, 4, 28)
    key = "frames" if cfg.frontend == "embeddings" else "tokens"
    plain = LM(cfg, device="cpu", params=params)
    mesh = logical(shape)
    step, model = psteps.build_decode_step(
        cfg, ShapeConfig("d", size, 4, "decode"), mesh, ShardingConfig())
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    head = {key: b[key][:, :24]}
    lg_a, c_a = plain.prefill(head, max_seq=size)
    _, c_b = model.prefill(shd.place_tree(head, lay["batch"](head), mesh),
                           max_seq=size, params=ps)
    for t in range(24, 28):
        inp = {key: b[key][:, t:t + 1]}
        lg_a, c_a = plain.decode_step(inp, c_a)
        x = shd.place_tree(inp, lay["batch"](inp), mesh)
        lg_b, c_b = step(ps, x, c_b)
        assert_allclose(shd.gather_tree(lg_b, [lay["logits"]], mesh).numpy(),
                        lg_a.numpy(), rtol=0, atol=SERVE_ATOL)
    _close_trees(shd.gather_tree(c_b, lay["cache"], mesh), c_a, SERVE_ATOL)
    with pytest.raises(ValueError, match="max_seq"):
        model.decode_step(x, c_b, params=ps)


@pytest.mark.parametrize("seq", [30, 3], ids=["S30", "S3"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_ctx_ragged_and_short_sequences(logical, seq, mode):
    """``ctx`` on m = 4 where S does not divide (qc = 8: the last shard
    holds 6 rows) and where S < m (one row on each of the first 3 shards,
    none on the last, which launches nothing), against unsharded."""
    cfg = preg.get_config("qwen3-0.6b:smoke")
    params = _params(cfg)
    b = _inputs(cfg, B, seq, seed=2)
    mesh = logical((2, 4))
    perf = ShardingConfig(attn_sharding="ctx")
    if mode == "train":
        step, _ = psteps.build_train_step(
            cfg, ShapeConfig("t", seq, B, "train"), TCFG, mesh=mesh,
            perf=perf)
        lay = step.layouts
        _, _, met = step(shd.place_tree(params, lay["params"], mesh),
                         psteps.init_opt_state(params, mesh, lay),
                         shd.place_tree(b, lay["batch"](b), mesh))
        plain, _ = psteps.build_train_step(
            cfg, ShapeConfig("t", seq, B, "train"), TCFG, "cpu")
        want = plain(params, popt.init(params), b)
        for k in ("loss", "grad_norm"):
            assert_allclose(float(met[k]), float(want[2][k]), rtol=1e-4)
        return
    n0 = col.CALLS["all_to_all"]
    step, _ = psteps.build_prefill_step(
        cfg, ShapeConfig("p", seq, B, "prefill"), mesh, perf)
    lay = step.layouts
    x = {"tokens": b["tokens"]}
    lgs, cs = step(shd.place_tree(params, lay["params"], mesh),
                   shd.place_tree(x, lay["batch"](x), mesh))
    # per layer, per data group: q to rows and the output back
    assert col.CALLS["all_to_all"] - n0 == 2 * cfg.n_layers * 2
    lg_a, c_a = LM(cfg, device="cpu", params=params).prefill(x)
    assert_allclose(shd.gather_tree(lgs, [lay["logits"]], mesh).numpy(),
                    lg_a.numpy(), rtol=0, atol=SERVE_ATOL)
    _close_trees(shd.gather_tree(cs, lay["cache"], mesh), c_a, SERVE_ATOL)


def test_ctx_chunks_follow_the_reference():
    """``_ctx_rows``: nq = m chunks of qc = ceil(S / m) rows, the last
    shorter or empty, as the reference pads nq * qc and drops the tail."""
    mesh = make_mesh((1, 4), devices=["cpu"] * 4)
    model = LM(preg.get_config("qwen3-0.6b:smoke"), mesh=mesh,
               perf=ShardingConfig(attn_sharding="ctx"))
    assert model._ctx_rows(32) == [(0, 8), (8, 8), (16, 8), (24, 8)]
    assert model._ctx_rows(30) == [(0, 8), (8, 8), (16, 8), (24, 6)]
    assert model._ctx_rows(3) == [(0, 1), (1, 1), (2, 1), (3, 0)]
    assert model._ctx_rows(5) == [(0, 2), (2, 2), (4, 1), (5, 0)]


@pytest.mark.parametrize("what", ["ctx", "heads-split", "seq_parallel",
                                  "rwkv", "vlm", "embeddings"])
def test_formerly_refused_options_build(logical, what):
    """Each option ``check_mesh`` refused before runs on a mesh; the
    attention mode follows the reference's ``make_model``."""
    arch, opts = TWINS[what]
    shape = (1, 8) if what == "heads-split" else (2, 4)
    model = LM(preg.get_config(arch + ":smoke"), mesh=logical(shape),
               perf=ShardingConfig(**opts))
    if arch.startswith("qwen3"):
        want = "ctx" if what == "ctx" else "heads"
        from repro_torch.models.model import attn_mode
        assert attn_mode(model.cfg, model.perf, model.msize) == want
        assert model._attn_split() == (
            "whole" if what == "heads-split" else want)


def test_unknown_attn_sharding_raises(logical):
    with pytest.raises(ValueError, match="attn_sharding"):
        LM(preg.get_config("qwen3-0.6b:smoke"), mesh=logical((2, 4)),
           perf=ShardingConfig(attn_sharding="rows"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-2b", "rwkv6-1.6b",
                                  "gemma2-2b"])
def test_seq_parallel_against_the_same_mesh(logical, arch):
    """``seq_parallel`` against the same (2, 4) step without it (the MoE
    included, whose capacity and aux loss are the sharded path's on both
    sides): the metrics within ``LOSS_TOL``, the params within
    ``PARAM_ATOL`` and the update within ``ADAM_BOUND``."""
    cfg = preg.get_config(arch + ":smoke")
    params = _params(cfg)
    b = _inputs(cfg, B, S, seed=3)
    mesh = logical((2, 4))
    out = []
    for sp in (False, True):
        step, _ = psteps.build_train_step(
            cfg, ShapeConfig("t", S, B, "train"), TCFG, mesh=mesh,
            perf=ShardingConfig(seq_parallel=sp))
        lay = step.layouts
        new_p, new_o, met = step(
            shd.place_tree(params, lay["params"], mesh),
            psteps.init_opt_state(params, mesh, lay),
            shd.place_tree(b, lay["batch"](b), mesh))
        out.append((shd.gather_tree(new_p, lay["params"], mesh),
                    shd.gather_tree(new_o, lay["opt"], mesh), met))
    (p0, o0, m0), (p1, o1, m1) = out
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert_allclose(float(m1[k]), float(m0[k]), **LOSS_TOL)
    _close_trees(p1, p0, PARAM_ATOL)
    assert adam_bound_ok(p1, p0, params, o1, o0, float(m0["lr"]))


def test_psum_replaced_by_reduce_scatter_under_seq_parallel(logical):
    """``seq_parallel`` on qwen3 (2, 4): every block's row-parallel output
    is reduce-scattered on S (no ``psum`` of a block output in the
    forward), its input all-gathered; the loss equals the non-SP step's
    on the same mesh within ``LOSS_TOL``."""
    cfg = preg.get_config("qwen3-0.6b:smoke")
    params = _params(cfg)
    b = _inputs(cfg, B, S)
    mesh = logical((2, 4))
    got = {}
    for sp in (False, True):
        step, model = psteps.build_train_step(
            cfg, ShapeConfig("t", S, B, "train"), TCFG, mesh=mesh,
            perf=ShardingConfig(seq_parallel=sp, layout="tp"))
        lay = step.layouts
        x = shd.place_tree(b, lay["batch"](b), mesh)
        ps = shd.place_tree(params, lay["params"], mesh)
        before = dict(col.CALLS)
        with torch.no_grad():
            loss, _ = model.loss(x, params=ps)
        got[sp] = (float(loss), {k: col.CALLS[k] - before[k]
                                 for k in before})
    # two blocks a layer, one reduce-scatter each on each data group
    assert got[True][1]["reduce_scatter"] == 2 * cfg.n_layers * 2
    assert got[True][1]["psum"] < got[False][1]["psum"]
    assert_allclose(got[True][0], got[False][0], **LOSS_TOL)


# --------------------------------------------------------------------------
# The kernel's plain version and its gradient at an offset
# --------------------------------------------------------------------------

@pytest.mark.parametrize("off,Sq,window,softcap", [
    (0, 40, 0, 0.0), (8, 32, 0, 0.0), (13, 20, 0, 0.0), (24, 16, 10, 0.0),
    (5, 1, 0, 30.0), (39, 1, 6, 30.0)])
def test_attention_ref_at_offset_is_rows_of_the_whole(rng, off, Sq, window,
                                                      softcap):
    Skv = 40
    q = torch.from_numpy(rng.normal(0, 2, (2, Skv, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, Skv, 2, 16)).astype(
        np.float32)) for _ in range(2))
    whole = attention_ref(q, k, v, window=window, softcap=softcap)
    part = attention_ref(q[:, off:off + Sq], k, v, window=window,
                         softcap=softcap, q_offset=off)
    assert_allclose(part.numpy(), whole[:, off:off + Sq].numpy(), rtol=0,
                    atol=1e-6)
    # the wrapper's CPU path is the plain version at the same offset
    out = fa_ops.flash_attention(q[:, off:off + Sq].contiguous(), k, v,
                                 window=window, softcap=softcap,
                                 q_offset=off)
    assert torch.equal(out, part)


@pytest.mark.parametrize("off,Sq", [(0, 24), (9, 15), (16, 8)])
def test_flash_fn_gradients_at_offset(rng, off, Sq):
    """``FlashAttentionFn`` at ``q_offset`` (forward: the plain version on
    the CPU; backward: the chunked plain backward at the offset)
    against autograd through the whole pass restricted to those rows."""
    Skv, window = 24, 11
    mk = lambda *shape: torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32))
    q, k, v = mk(2, Skv, 4, 16), mk(2, Skv, 2, 16), mk(2, Skv, 2, 16)
    dout = mk(2, Sq, 4, 16)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    whole = attention_ref(qa, ka, va, window=window, scale=1.0)
    gq, gk, gv = torch.autograd.grad(
        (whole[:, off:off + Sq] * dout).sum(), (qa, ka, va))
    qb = q[:, off:off + Sq].clone().requires_grad_()
    kb, vb = (t.clone().requires_grad_() for t in (k, v))
    out = FlashAttentionFn.apply(qb, kb, vb, window, 0.0, off)
    assert_allclose(out.detach().numpy(),
                    whole[:, off:off + Sq].detach().numpy(), rtol=0,
                    atol=1e-6)
    dq, dk, dv = torch.autograd.grad(out, (qb, kb, vb), dout)
    for got, want in ((dq, gq[:, off:off + Sq]), (dk, gk), (dv, gv)):
        assert_allclose(got.numpy(), want.numpy(), rtol=0,
                        atol=1e-5 * max(float(want.abs().max()), 1.0))
    assert float(gq[:, :off].abs().max() if off else 0.0) == 0.0


def test_flash_wrapper_refuses_rows_past_the_keys():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 10, 2, 16))
    with pytest.raises(ValueError, match="offset"):
        fa_ops.flash_attention(q, k, k, q_offset=3)
    with pytest.raises(ValueError, match="offset"):
        fa_ops.flash_attention(q, k, k, q_offset=-1)


def test_all_to_all_and_its_backward():
    """Member j gets block j (along ``split_dim``, ragged sizes) of every
    member's tensor, concatenated along ``cat_dim``; the backward puts
    every block of the gradient back where it came from."""
    mesh = make_mesh((2, 3), devices=["cpu"] * 6)
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn((2, 7, 3), generator=g).requires_grad_()
          for _ in range(6)]
    sizes = [3, 4, 0]
    ys = col.all_to_all(xs, mesh, "model", 1, 2, sizes)
    starts = [0, 3, 7]
    for grp in mesh.groups("model"):
        for j, i in enumerate(grp):
            want = torch.cat([xs[m][:, starts[j]:starts[j] + sizes[j]]
                              for m in grp], dim=2)
            assert torch.equal(ys[i], want)
    ws = [torch.randn(y.shape, generator=g) for y in ys]
    grads = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)),
                                xs)
    for grp in mesh.groups("model"):
        for m, i in enumerate(grp):
            want = torch.cat([ws[grp[j]][:, :, 3 * m:3 * m + 3]
                              for j in range(3)], dim=1)
            assert torch.equal(grads[i], want)
