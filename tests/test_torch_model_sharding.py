"""The model-sharding planner against the reference's, exactly.

Every leaf of all ten archs at published widths (``ParamDef`` trees only,
nothing allocated), on the (16, 16), (2, 16, 16), (2, 4) and (1, 1)
meshes of the reference's ``make_abstract_mesh``: the port's spec of each
leaf must equal the reference's spec of the same leaf, trailing
replicated dims padded. The reference stacks pattern groups under a
leading ``layers`` dim; the port keeps a layer list, so a stacked leaf's
spec goes through the reference's ``strip_leading_dim`` first. Cases:
``param_rules``, ``zero1_shardings`` and ``cache_rules`` (the cache of
``decode_32k``, and ``long_500k`` for the sub-quadratic archs) under the
default ``ShardingConfig``, ``embed_shard="d_model"``, ``zero1=False`` and
``shard_cache_seq=False``; ``batch_sharding``; and the reference's four
unit tests of ``resolve`` and ``zero1_shardings``
(``tests/test_distribution.py``) as cases of one test.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.configs.base import ShardingConfig as JaxSharding
from repro.distribution import sharding as jshd
from repro.models import LM as JaxLM
from repro.models import param as JPm
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShardingConfig
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.distribution import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import param as Pm
from repro_torch.models.model import cache_defs, param_defs
from repro_torch.train import tree as tr

MESHES = {
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
    "2x4": (("data", 2), ("model", 4)),
    "1x1": (("data", 1), ("model", 1)),
}
VARIANTS = {
    "default": {},
    "embed_d_model": {"embed_shard": "d_model"},
    "no_zero1": {"zero1": False},
    "no_cache_seq": {"shard_cache_seq": False},
}


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _port_ids(jdefs, pcfg, cache=False):
    """The reference leaf index of every leaf of the port layout."""
    leaves, treedef = jax.tree.flatten(
        jdefs, is_leaf=lambda x: isinstance(x, JPm.ParamDef))
    ids = jax.tree.unflatten(treedef, [
        np.full(d.shape[:1], i) if d.dims and d.dims[0] == "layers"
        else np.array(i) for i, d in enumerate(leaves)])
    conv = lm_cache_from_numpy if cache else lm_params_from_numpy
    return [int(t.reshape(-1)[0]) for t in tr.leaves(conv(ids, pcfg))], \
        leaves


def _compare(ref_tree, port_specs, ids, jleaves, pdefs):
    ref = jax.tree.leaves(ref_tree,
                          is_leaf=lambda x: hasattr(x, "spec"))
    pleaves = Pm.leaves(pdefs)
    got = shd.spec_leaves(port_specs)
    assert len(ids) == len(got) == len(pleaves)
    for k, (jid, spec, d) in enumerate(zip(ids, got, pleaves)):
        r = ref[jid]
        if jleaves[jid].dims[0:1] == ("layers",):
            r = jshd.strip_leading_dim(r, r.mesh)
        assert _pad(spec, len(d.shape)) == _pad(r.spec, len(d.shape)), \
            (k, d.dims, d.shape, spec, r.spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_planner_matches_reference(arch, mesh_name):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    amesh = jshd.make_abstract_mesh(MESHES[mesh_name])
    jm = JaxLM(jcfg)
    jdefs = jm.param_defs()
    pdefs = param_defs(pcfg)
    ids, jleaves = _port_ids(jdefs, pcfg)
    specs, dims = JPm.specs(jdefs), JPm.dims(jdefs)
    shapes = [SHAPES["decode_32k"]] + ([SHAPES["long_500k"]]
                                       if jcfg.sub_quadratic else [])
    for kw in VARIANTS.values():
        jperf, pperf = JaxSharding(**kw), ShardingConfig(**kw)
        _compare(jshd.tree_shardings(specs, dims, amesh,
                                     jshd.param_rules(jperf)),
                 shd.tree_shardings(pdefs, amesh, shd.param_rules(pperf)),
                 ids, jleaves, pdefs)
        _compare(jshd.zero1_shardings(specs, dims, amesh, jperf),
                 shd.zero1_shardings(pdefs, amesh, pperf),
                 ids, jleaves, pdefs)
        for sh in shapes:
            B, S = sh.global_batch, sh.seq_len
            jc = jm.cache_defs(B, S)
            pc = cache_defs(pcfg, B, S)
            cids, cleaves = _port_ids(jc, pcfg, cache=True)
            _compare(jshd.tree_shardings(JPm.specs(jc), JPm.dims(jc), amesh,
                                         jshd.cache_rules(jperf)),
                     shd.tree_shardings(pc, amesh, shd.cache_rules(pperf)),
                     cids, cleaves, pc)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_sharding_matches_reference(mesh_name):
    amesh = jshd.make_abstract_mesh(MESHES[mesh_name])
    for ndim in (1, 2, 3):
        for bs in (None, 1, 2, 8, 12, 32, 256, 512):
            for seq_axis in (None, 1) if ndim > 1 else (None,):
                r = jshd.batch_sharding(amesh, ndim, JaxSharding(),
                                        seq_axis=seq_axis, batch_size=bs)
                p = shd.batch_sharding(amesh, ndim, ShardingConfig(),
                                       seq_axis=seq_axis, batch_size=bs)
                assert _pad(p, ndim) == _pad(r.spec, ndim)
    assert _pad(shd.replicated(amesh), 2) == \
        _pad(jshd.replicated(amesh).spec, 2)


def _unit_spec(shape, dims):
    mesh = shd.make_abstract_mesh((("data", 16), ("model", 16)))
    return shd.resolve(shape, dims, mesh, shd.param_rules(ShardingConfig()))


@pytest.mark.parametrize("case", ["vocab_falls_back_to_d_model",
                                  "experts_beat_d_ff",
                                  "d_model_never_steals_from_heads_flat",
                                  "zero1_never_shards_layers",
                                  "act_rules"])
def test_reference_unit_cases(case):
    """``tests/test_distribution.py``'s four cases on the port, and the
    activation rules equal to the reference's."""
    if case == "act_rules":
        for sp in (False, True):
            assert shd.act_rules(ShardingConfig(seq_parallel=sp)) == \
                jshd.act_rules(JaxSharding(seq_parallel=sp))
        return
    if case == "vocab_falls_back_to_d_model":
        # internvl2's vocab 92553 % 16 != 0 -> d_model takes 'model'
        assert _unit_spec((92553, 6144), ("vocab", "d_model")) == \
            (None, "model")
    elif case == "experts_beat_d_ff":
        assert _unit_spec((16, 4096, 6400), ("experts", "d_model",
                                             "d_ff")) == \
            ("model", None, None)
    elif case == "d_model_never_steals_from_heads_flat":
        assert _unit_spec((4096, 2048), ("d_model", "heads_flat")) == \
            (None, "model")
    else:
        mesh = shd.make_abstract_mesh((("data", 16), ("model", 16)))
        defs = {"w": Pm.ParamDef((32, 4096, 6400),
                                 ("layers", "d_model", "d_ff"),
                                 torch.float32)}
        # layers (32, divisible by 16) must NOT get 'data'; d_model does
        out = shd.zero1_shardings(defs, mesh, ShardingConfig())
        assert out["w"] == (None, "data", "model")


def test_meshes_and_placement(monkeypatch):
    """The production mesh needs 256 (512) devices; logical shards give
    them; ``place_tree`` and ``gather_tree`` are inverse."""
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh(device="cpu")
    monkeypatch.setattr(shd, "visible_devices",
                        lambda device: [torch.device("cpu")] * 512)
    assert make_production_mesh(device="cpu").shape == \
        {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True, device="cpu")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod.axis_index(pod.size - 1, ("pod", "data")) == 31
    mesh = make_mesh((2, 4), device="cpu")
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 12, generator=g),
            "b": [torch.randn(4, generator=g), torch.randn(3, generator=g)]}
    specs = {"a": ("data", "model"), "b": [("model",), ()]}
    shards = shd.place_tree(tree, specs, mesh)
    assert shards[5]["a"].shape == (4, 3)
    assert torch.equal(shards[5]["a"], tree["a"][4:8, 3:6])
    back = shd.gather_tree(shards, specs, mesh)
    assert all(torch.equal(x, y) for x, y in zip(tr.leaves(back),
                                                 tr.leaves(tree)))


def test_collectives_fixed_order_and_conjugate_backward(monkeypatch):
    """``psum`` adds in shard order ((x0 + x1) + x2) + x3, bit for bit,
    and every member holds it; ``all_gather`` concatenates in shard order;
    ``reduce_scatter`` is the psum's blocks; each backward is the
    conjugate collective (psum -> psum, all_gather -> reduce_scatter,
    reduce_scatter -> all_gather); a group of one is the identity."""
    from repro_torch.distribution import collectives as col
    mesh = make_mesh((2, 4), devices=["cpu"] * 8)
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 6, generator=g, requires_grad=True)
          for _ in range(8)]
    groups = mesh.groups("model")
    ys = col.psum(xs, mesh, "model")
    for grp in groups:
        want = ((xs[grp[0]] + xs[grp[1]]) + xs[grp[2]]) + xs[grp[3]]
        assert all(torch.equal(ys[i], want) for i in grp)
    ws = [torch.randn(4, 6, generator=g) for _ in range(8)]
    grads = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)),
                                xs)
    for grp in groups:
        want = ((ws[grp[0]] + ws[grp[1]]) + ws[grp[2]]) + ws[grp[3]]
        assert all(torch.equal(grads[i], want) for i in grp)
    zs = col.all_gather(xs, mesh, "model", 1)
    assert torch.equal(zs[5], torch.cat([xs[i] for i in groups[1]], 1))
    wz = [torch.randn(4, 24, generator=g) for _ in range(8)]
    gz = torch.autograd.grad(sum((z * w).sum() for z, w in zip(zs, wz)), xs)
    rs = col.reduce_scatter(wz, mesh, "model", 1)
    assert all(torch.equal(a, b) for a, b in zip(gz, rs))
    gr = torch.autograd.grad(
        sum((r * x).sum() for r, x in zip(
            col.reduce_scatter([w.requires_grad_() for w in wz], mesh,
                               "model", 1), xs)), wz)
    assert all(torch.equal(a, b) for a, b in
               zip(gr, col.all_gather([x.detach() for x in xs], mesh,
                                      "model", 1)))
    one = make_mesh((1, 1), devices=["cpu"])
    assert col.psum(xs[:1], one, "model")[0] is xs[0]
