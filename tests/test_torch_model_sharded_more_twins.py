"""The rest of model sharding on a mesh of logical shards, on the CPU, part
three of ``test_torch_model_sharded_more.py`` (which holds the options,
the helpers these tests share, and in its docstring the bounds): every
option's train step on (2, 4) and (1, 8) against ``mesh=None``.
"""
import pytest
from numpy.testing import assert_allclose

from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.distribution import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.models import LM
from repro_torch.train import optimizer as popt
from repro_torch.train import tree as tr
from test_torch_model_sharded_more import B, S, TWINS, _inputs, _params, logical
from test_torch_model_sharded_steps import (GRAD_REL, LOSS_TOL, PARAM_ATOL,
                                            TCFG, _close_trees, adam_bound_ok)

assert logical  # a fixture of these tests


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
@pytest.mark.parametrize("what", list(TWINS))
def test_train_step_against_unsharded(logical, what, shape):
    arch, opts = TWINS[what]
    cfg = preg.get_config(arch + ":smoke")
    params = _params(cfg)
    b = _inputs(cfg, B, S)
    mesh = logical(shape)
    step, _ = psteps.build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                                      TCFG, mesh=mesh,
                                      perf=ShardingConfig(**opts))
    lay = step.layouts
    new_p, new_o, met = step(shd.place_tree(params, lay["params"], mesh),
                             psteps.init_opt_state(params, mesh, lay),
                             shd.place_tree(b, lay["batch"](b), mesh))
    plain, _ = psteps.build_train_step(
        cfg, ShapeConfig("t", S, B, "train"), TCFG, "cpu",
        model=LM(cfg, device="cpu", params=params,
                 rwkv_chunk=opts.get("rwkv_chunk", 0)))
    want = plain(params, popt.init(params), b)
    for k in ("loss", "ce", "aux", "lr"):
        assert_allclose(float(met[k]), float(want[2][k]), **LOSS_TOL)
    assert_allclose(float(met["grad_norm"]), float(want[2]["grad_norm"]),
                    rtol=1e-4)
    got_p = shd.gather_tree(new_p, lay["params"], mesh)
    got_o = shd.gather_tree(new_o, lay["opt"], mesh)
    for a, c in zip(tr.leaves(got_o["m"]), tr.leaves(want[1]["m"])):
        assert_allclose(a.numpy(), c.numpy(), rtol=0,
                        atol=GRAD_REL * max(float(c.abs().max()), 1e-30))
    _close_trees(got_p, want[0], PARAM_ATOL)
    assert adam_bound_ok(got_p, want[0], params, got_o, want[1],
                         float(want[2]["lr"]))
