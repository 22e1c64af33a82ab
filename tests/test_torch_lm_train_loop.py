"""The port's LM training loop, launcher, straggler policy and gradient
compression, on the CPU, beside the reference's.

  * the loss falls over 60 steps (``tests/test_train_serve.py``'s
    ``test_loss_decreases``, the same config, shape and schedule);
  * 20 steps straight equal 10 steps, a "crash", a restore from the
    newest complete checkpoint and 10 more, loss for loss and bit for bit
    (the same ops on the same batches, restored from exact copies);
  * the straggler policy gives the reference's verdicts on one sequence
    of step times;
  * the int8 error-feedback compression gives the reference's payload and
    scales exactly (``round`` is round-half-to-even in both) and its
    error buffer within 1e-7; with error feedback the running sum of the
    decompressed gradients tracks the true sum within one quantization
    step;
  * the launcher trains, resumes from its checkpoint, refuses the mesh
    options, and without ``--device cpu`` raises on a machine with no
    card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.distribution import compression as jcomp
from repro.train.loop import StragglerPolicy as JaxStraggler
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import (Prefetcher, StreamCursor,
                                       SyntheticLMStream)
from repro_torch.distribution import compression as comp
from repro_torch.launch import train as launcher
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import StragglerPolicy, train

SHAPE = ShapeConfig("test", 32, 4, "train")


def _tcfg(tmp, **kw):
    base = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                checkpoint_every=10, checkpoint_dir=str(tmp),
                keep_checkpoints=2, async_checkpoint=False)
    base.update(kw)
    return TrainConfig(**base)


def test_loss_decreases(tmp_path):
    cfg = get_config("qwen3-0.6b:smoke")
    res = train(cfg, SHAPE, device="cpu",
                tcfg=_tcfg(tmp_path, total_steps=60, learning_rate=3e-3))
    assert res.steps_run == 60 and res.restored_from is None
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.05, (first, last)


def test_crash_resume_is_deterministic(tmp_path):
    """train 20 straight == train 10, 'crash', restore, train 10 more."""
    cfg = get_config("qwen3-0.6b:smoke")
    tc = dict(total_steps=20, checkpoint_every=10)
    straight = train(cfg, SHAPE, device="cpu",
                     tcfg=_tcfg(tmp_path / "a", **tc))
    first = train(cfg, SHAPE, device="cpu",
                  tcfg=_tcfg(tmp_path / "b", **tc), max_steps=10)
    resumed = train(cfg, SHAPE, device="cpu",
                    tcfg=_tcfg(tmp_path / "b", **tc))
    assert first.final_step == 10 and resumed.restored_from == 10
    assert resumed.steps_run == 10 and resumed.final_step == 20
    assert straight.losses[:10] == first.losses
    assert straight.losses[10:] == resumed.losses
    # the newest complete step is picked; a stale .tmp never is
    ck = Checkpointer(str(tmp_path / "b"), async_mode=False)
    (tmp_path / "b" / "step_00000099.tmp").mkdir()
    assert ck.latest_step() == 20


def test_bfloat16_train_state_checkpoints_and_resumes(tmp_path):
    """bfloat16 weights (the published configs' dtype) through the
    checkpointer bit for bit, and a bfloat16 run resumed; the model holds
    the trained weights after each step (``LM.load_params``)."""
    import dataclasses
    ck = Checkpointer(str(tmp_path / "ck"), async_mode=False)
    t = {"w": torch.randn(5, 3).to(torch.bfloat16),
         "step": torch.tensor(3, dtype=torch.int32)}
    ck.save(1, t)
    back, _ = ck.restore(1, t)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), t["w"].view(torch.int16))
    cfg = dataclasses.replace(get_config("qwen3-0.6b:smoke"),
                              dtype="bfloat16", param_dtype="bfloat16")
    shape = ShapeConfig("t", 16, 2, "train")
    tc = dict(total_steps=4, checkpoint_every=2)
    straight = train(cfg, shape, device="cpu",
                     tcfg=_tcfg(tmp_path / "a", **tc))
    train(cfg, shape, device="cpu", tcfg=_tcfg(tmp_path / "b", **tc),
          max_steps=2)
    resumed = train(cfg, shape, device="cpu",
                    tcfg=_tcfg(tmp_path / "b", **tc))
    assert resumed.restored_from == 2
    assert straight.losses[2:] == resumed.losses


def test_prefetcher_advances_the_cursor():
    stream = SyntheticLMStream(64, 2, 8, seed=1)
    cursor = StreamCursor(batch_index=3)
    pf = Prefetcher(stream, cursor, device="cpu")
    a = pf.next()
    assert cursor.batch_index == 4
    np.testing.assert_array_equal(a["tokens"].numpy(),
                                  stream.make_batch(3)["tokens"])
    assert StreamCursor.from_dict(cursor.state_dict()) == cursor
    assert isinstance(Prefetcher(stream, StreamCursor()).next()["tokens"],
                      np.ndarray)


def test_straggler_policy_detects_slow_steps():
    times = [0.1] * 10 + [1.0, 1.0, 1.0, 0.1, 1.0, 0.1]
    p, j = StragglerPolicy(k=3.0, consecutive_to_fail=3, min_steps=3), \
        JaxStraggler(k=3.0, consecutive_to_fail=3, min_steps=3)
    got = [p.observe(t) for t in times]
    assert got == [j.observe(t) for t in times]
    assert got[10:13] == ["slow", "slow", "fail"]
    assert p.slow_events == j.slow_events == 4
    assert p.ewma == j.ewma


def test_grad_compression_matches_jax_and_converges(rng):
    g = {"b": rng.normal(0, 1e-3, (7,)).astype(np.float32),
         "w": rng.normal(0, 0.1, (64, 64)).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    q, s, ef = comp.compress_grads(tg, comp.init_ef(tg))
    jq, js, jef = jcomp.compress_grads(jg, jcomp.init_ef(jg))
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        assert float(s[k]) == float(js[k])
        assert_allclose(ef.error[k].numpy(), np.asarray(jef.error[k]),
                        rtol=0, atol=1e-7)
    recon = comp.decompress_grads(q, s)
    rel = float(torch.linalg.norm(recon["w"] - tg["w"])
                / torch.linalg.norm(tg["w"]))
    assert rel < 0.02
    # error feedback: the sum of what was sent tracks the sum of the true
    # grads within one quantization step of the last round
    ef = comp.init_ef(tg)
    sent = torch.zeros(64, 64)
    for i in range(20):
        step = {k: v * (1 + 0.1 * i) for k, v in tg.items()}
        out, ef = comp.roundtrip(step, ef)
        sent += out["w"]
    true = sum(tg["w"] * (1 + 0.1 * i) for i in range(20))
    assert float((sent - true).abs().max()) <= float(s["w"]) * 3.0 + 1e-6


def test_launcher_trains_resumes_and_refuses(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b:smoke", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path), "--lr", "3e-3"]
    launcher.main(argv)
    out = capsys.readouterr().out
    assert '"steps_run": 6' in out and '"restored_from": null' in out
    launcher.main(argv[:5] + ["8"] + argv[6:])
    out = capsys.readouterr().out
    assert '"restored_from": 6' in out and '"steps_run": 2' in out
    for bad in (["--production-mesh"], ["--set", "layout=tp"]):
        with pytest.raises(SystemExit):
            launcher.main(argv + bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launcher.main(["--arch", "qwen3-0.6b:smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "c")])
