"""The port's ServeEngine and launcher against the JAX package's, on the CPU.

Both engines serve the same ``:smoke`` model (the reference's params moved
across with ``convert.lm_params_from_numpy``) on the same requests: dense
attention (qwen3, gemma2), the recurrent families (recurrentgemma, rwkv6)
and MoE (moonshot). Greedy
tokens can flip between frameworks on near-ties (summation order differs,
as ``tests/test_train_serve.py`` warns within JAX), so every engine step's
logits are also held within 1e-4, and token equality is asserted where the
reference's top-2 gap exceeds that bound; the seeds are chosen so that it
does at every step.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import LM as JaxLM
from repro.serve import engine as jengine
from repro_torch.configs import registry as preg
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.serve import engine as pengine

TOL = 1e-4


def _recording(engine, log):
    """Record the logits of every engine step (admission feeds included)."""
    step = engine._step_masked

    def run(tokens, mask):
        logits = step(tokens, mask)
        log.append(np.asarray(logits if not torch.is_tensor(logits)
                              else logits.numpy(), np.float32))
        return logits
    engine._step_masked = run


def _requests(mod, rng, vocab, n, prompt_len, new_tokens):
    reqs = [mod.Request(rid=i, prompt=rng.randint(1, vocab, (prompt_len,))
                        .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n)]
    reqs[-1].deadline_s = 0.0   # retires on its first token: "timeout"
    return reqs


@pytest.mark.parametrize("arch,seed", [("qwen3-0.6b:smoke", 0),
                                       ("qwen3-0.6b:smoke", 1),
                                       ("gemma2-2b:smoke", 0),
                                       ("recurrentgemma-2b:smoke", 0),
                                       ("rwkv6-1.6b:smoke", 1),
                                       ("moonshot-v1-16b-a3b:smoke", 0)])
def test_engine_matches_jax(arch, seed):
    """7 requests on 3 slots, so slots are reused: a reused slot of a
    recurrent model keeps the RG-LRU/RWKV state its last request left
    (admission resets ``lengths`` only, in both engines), and the MoE
    decode routes 3 slots at a capacity of 1 per expert."""
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    jm = JaxLM(jcfg, remat_policy="none")
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = LM(pcfg, device="cpu", params=lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), pcfg))
    je = jengine.ServeEngine(jm, jp, batch_slots=3, max_seq=64)
    pe = pengine.ServeEngine(pm, batch_slots=3, max_seq=64)
    jlog, plog = [], []
    _recording(je, jlog)
    _recording(pe, plog)
    jreqs = _requests(jengine, np.random.RandomState(seed), jcfg.vocab_size,
                      7, 5, 6)
    preqs = _requests(pengine, np.random.RandomState(seed), pcfg.vocab_size,
                      7, 5, 6)
    je.run_until_drained(jreqs)
    pe.run_until_drained(preqs)

    assert len(plog) == len(jlog) > 0
    for want, got in zip(jlog, plog):
        assert_allclose(got, want, rtol=TOL, atol=TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > TOL).all(), \
            "a near-tie: pick another seed"
    for j, p in zip(jreqs, preqs):
        assert p.tokens == j.tokens
        assert (p.done, p.finish_reason) == (j.done, j.finish_reason)
    assert preqs[-1].finish_reason == "timeout"
    assert pe.stats == je.stats
    assert pe.stats["timeouts"] == 1 and pe.stats["admitted"] == 7
    # the caches the engines end with: every slot's rows, reused slots'
    # recurrent states included
    want = lm_cache_from_numpy(jax.tree.map(np.asarray, je.cache), pcfg)
    assert torch.equal(want["lengths"], pe.cache["lengths"])
    for w, g in zip(want["layers"], pe.cache["layers"]):
        assert set(w) == set(g)
        for key in w:
            assert_allclose(g[key].numpy(), w[key].numpy(), rtol=TOL,
                            atol=TOL)


def test_engine_continuous_batching(rng):
    cfg = preg.get_config("qwen3-0.6b:smoke")
    engine = pengine.ServeEngine(LM(cfg, device="cpu"), batch_slots=3,
                                 max_seq=64)
    reqs = [pengine.Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, (5,))
                            .astype(np.int32), max_new_tokens=6)
            for i in range(7)]
    engine.run_until_drained(reqs)
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    # 7 requests on 3 slots overlap: fewer ticks than one at a time
    assert 12 <= engine.stats["ticks"] < 42


def test_engine_sampling_is_seeded():
    cfg = preg.get_config("qwen3-0.6b:smoke")
    model = LM(cfg, device="cpu")
    outs = []
    for _ in range(2):
        engine = pengine.ServeEngine(model, 2, 32, greedy=False, seed=3)
        req = pengine.Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                              max_new_tokens=8)
        engine.run_until_drained([req])
        outs.append(req.tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 8


@pytest.mark.parametrize("arch", ["qwen3-0.6b:smoke",
                                  "recurrentgemma-2b:smoke"])
def test_launcher_matches_reference_stats(arch, capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve
    args = ["--arch", arch, "--requests", "5",
            "--new-tokens", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    pserve.main([*args, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    for key in ("requests", "completed", "tokens", "engine"):
        assert got[key] == want[key]


def test_launcher_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    from repro_torch.launch import serve as pserve
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pserve.main(["--arch", "qwen3-0.6b:smoke"])
