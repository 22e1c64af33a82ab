"""The rest of model sharding on a mesh of logical shards, on the CPU, part
two of ``test_torch_model_sharded_more.py`` (which holds the cells, the
JAX subprocess and the helpers these tests share, and its docstring the
bounds): the reference's cells of the other families (recurrentgemma-2b
on (1, 8), ``auto`` picking ``ctx``, train and decode; rwkv6-1.6b train
and decode; musicgen-medium (frames) train; internvl2-26b (patches) train
and prefill), run by this file's own JAX subprocess, and every option's
prefill and decode steps on (2, 4) and (1, 8) against ``mesh=None``.
"""
import pytest
from numpy.testing import assert_allclose

from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig, ShardingConfig
from repro_torch.distribution import sharding as shd
from repro_torch.launch import steps as psteps
from repro_torch.models import LM
from test_torch_model_sharded_more import (TWINS, _inputs, _params,
                                           check_decode_cell,
                                           check_prefill_cell,
                                           check_train_cell, logical,
                                           run_jax_cells)
from test_torch_model_sharded_steps import SERVE_ATOL, _close_trees

assert logical  # a fixture of these tests

# this file's reference cells
TRAIN_CELLS = ("rg-auto", "rwkv-train", "music-train", "vlm-train")
DECODE_CELLS = ("rg-decode", "rwkv-decode")
PREFILL_CELLS = ("vlm-prefill",)


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    return run_jax_cells(tmp_path_factory,
                         TRAIN_CELLS + DECODE_CELLS + PREFILL_CELLS)


@pytest.mark.parametrize("key", TRAIN_CELLS)
def test_train_cell_matches_reference(jax_cells, logical, key):
    check_train_cell(jax_cells, logical, key)


@pytest.mark.parametrize("key", DECODE_CELLS)
def test_decode_cell_matches_reference(jax_cells, logical, key):
    check_decode_cell(jax_cells, logical, key)


def test_prefill_cell_matches_reference(jax_cells, logical):
    check_prefill_cell(jax_cells, logical, PREFILL_CELLS[0])


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
@pytest.mark.parametrize("what", list(TWINS))
def test_prefill_and_decode_against_unsharded(logical, what, shape):
    """A 24-position prefill into a 32-slot cache (``vlm``: 8 patches
    and 24 tokens into 40), then 4 decode steps: every step's logits and
    the final cache within ``SERVE_ATOL`` of the unsharded model's."""
    arch, opts = TWINS[what]
    cfg = preg.get_config(arch + ":smoke")
    params = _params(cfg)
    extra = cfg.n_patches if cfg.frontend == "vlm" else 0
    b = _inputs(cfg, 4, 28 + extra)
    head = {k: v if k == "patches" else v[:, :24]
            for k, v in b.items() if k != "targets"}
    steps_in = [{k: v[:, t:t + 1]} for t in range(24, 28)
                for k, v in b.items() if k in ("tokens", "frames")]
    size = 32 + extra
    chunk = opts.get("rwkv_chunk", 0)
    plain = LM(cfg, device="cpu", params=params, rwkv_chunk=chunk)
    mesh = logical(shape)
    step, model = psteps.build_decode_step(
        cfg, ShapeConfig("d", size, 4, "decode"), mesh,
        ShardingConfig(**opts))
    model.load_params(params)
    lay = step.layouts
    ps = shd.place_tree(params, lay["params"], mesh)
    lg_a, c_a = plain.prefill(head, max_seq=size)
    lg_b, c_b = model.prefill(shd.place_tree(head, lay["batch"](head), mesh),
                              max_seq=size, params=ps)
    for inp in steps_in + [None]:
        got = shd.gather_tree(lg_b, [lay["logits"]], mesh)
        assert_allclose(got.numpy(), lg_a.numpy(), rtol=0, atol=SERVE_ATOL)
        if inp is None:
            break
        lg_a, c_a = plain.decode_step(inp, c_a)
        lg_b, c_b = step(ps, shd.place_tree(inp, lay["batch"](inp), mesh),
                         c_b)
    _close_trees(shd.gather_tree(c_b, lay["cache"], mesh), c_a, SERVE_ATOL)
