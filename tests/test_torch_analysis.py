"""The port's contract gate (``analysis.check``, ``analysis.lint``) against
the reference's (``repro.analysis``).

Mirrors ``tests/test_analysis.py`` with a bad/good pair per rule: the
custom-reward fault of ROADMAP queue 3 (a cross-env mean that the port
used to accept, whose sharded rewards then differed from the unsharded
ones) refused where the reference refuses it — at ``RewardSpec``
construction and, with ``unchecked=True``, at the sharded system's
construction — with the reference's rule ids; ``reward-shape``;
``callback-in-scan`` in a decide step and in a train step;
``time-cast`` of the tick counter and of the replay's ``tick_idx``; the
two lint rules on fixture sources; the lint's command line (baseline,
formats, ``--builtins``); ``check_builtins`` and the lint over the tree;
and an import guard: every ``repro_torch`` module imports with
``jax`` and ``repro`` made unimportable.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import ContractViolation as JaxViolation
from repro.core.reward import RewardSpec as JaxSpec
from repro.core.reward import RewardTerm as JaxTerm
from repro_torch.analysis import check as ck
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.contracts import (LINT_RULES, RULES,
                                            ContractViolation)
from repro_torch.core import PipelineConfig
from repro_torch.core import replay as rp
from repro_torch.core.reward import RewardSpec, RewardTerm
from repro_torch.distribution import sharding as sh
from repro_torch.runtime.policies import POLICIES
from repro_torch.runtime.predictor import (ActionSpace, DecideFns,
                                           ModelAdapter, Predictor,
                                           linear_policy)
from repro_torch.runtime.receivers import SimulatedDevice
from repro_torch.runtime.system import PerceptaSystem, SourceSpec
from repro_torch.runtime.trainer import OnlineTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, F, A = 4, 6, 2
# ROADMAP queue 3's input: tests/test_torch_sharded.py's sources and PCFG
QE = 12
PCFG = dict(n_streams=3, n_ticks=8, tick_s=60.0, max_samples=16,
            gap_strategy="locf", feature_agg="mean", k_sigma=4.0)
SPACE = (np.array([-1.0, -0.5]), np.array([1.0, 0.5]))


def _centred(f, a, p):
    return f[:, 0] - f[:, 0].mean()


def _rules(found):
    return [v.rule for v in found]


# ----------------------------------------------------- queue 3's fault
def _queue3_system(mode, spec, **kw):
    cfg = PipelineConfig(n_envs=QE, **PCFG)
    pred = Predictor("linear", spec, ActionSpace(*SPACE), QE,
                     cfg.n_features, replay_capacity=4, device="cpu")
    sources = [
        SourceSpec("meter", "mqtt", SimulatedDevice("grid_kw", 60.0,
                                                    base=3.0, seed=1)),
        SourceSpec("price", "http", SimulatedDevice(
            "price_eur", 300.0, base=0.2, amplitude=0.05, seed=2)),
        SourceSpec("thermo", "amqp", SimulatedDevice(
            "temp_c", 30.0, base=21.0, amplitude=1.5, seed=3)),
    ]
    return PerceptaSystem([f"bldg-{i}" for i in range(QE)], sources, cfg,
                          pred, mode=mode, manual_time=True, scan_k=3,
                          device="cpu", **kw)


@pytest.fixture
def two_shards(monkeypatch):
    monkeypatch.setattr(sh, "visible_devices",
                        lambda device: [torch.device(device)] * 2)


def test_queue3_custom_reward_refused_at_spec_construction():
    """The cross-env mean is refused by rule id when the spec is built, in
    the port as in the reference."""
    with pytest.raises(ContractViolation) as ei:
        RewardSpec((RewardTerm("custom", fn=_centred),))
    assert _rules(ei.value.violations) == ["env-reduce"]
    with pytest.raises(JaxViolation) as ej:
        JaxSpec((JaxTerm("custom", fn=lambda f, a, p:
                         f[:, 0] - f[:, 0].mean()),))
    assert "env-reduce" in str(ej.value)


def test_queue3_unchecked_spec_refused_at_sharded_system(two_shards):
    """``unchecked=True`` builds the spec; the sharded fused system on 2
    logical shards refuses it again (the decide step's rows probe), while
    the unsharded fused system, where the env rules do not bind, and an
    opted-out sharded one run."""
    spec = RewardSpec((RewardTerm("custom", fn=_centred),), unchecked=True)
    assert spec.unchecked
    for mode in ("scan_fused_decide_sharded",
                 "scan_fused_decide_async_sharded"):
        with pytest.raises(ContractViolation) as ei:
            _queue3_system(mode, spec)
        assert "[env-reduce]" in str(ei.value)
        assert "fused decide.step" in str(ei.value)
    system = _queue3_system("scan_fused_decide", spec)
    assert len(system.run_windows(3)) == 3
    system.stop()
    system = _queue3_system("scan_fused_decide_sharded", spec,
                            contract_check=False)
    assert len(system.run_windows(3)) == 3
    system.stop()


def test_reward_shape_rule():
    bad = lambda f, a, p: f[:, :2]                 # (E, 2)
    good = lambda f, a, p: f[:, 0] * 2.0
    with pytest.raises(ContractViolation) as ei:
        RewardSpec((RewardTerm("custom", fn=bad),))
    assert _rules(ei.value.violations) == ["reward-shape"]
    with pytest.raises(JaxViolation, match="reward-shape"):
        JaxSpec((JaxTerm("custom", fn=bad),))
    RewardSpec((RewardTerm("custom", fn=good),))   # must not raise
    # a fn sized by E (a closed-over (4,) weight) fails at E + 1
    w = torch.ones(E)
    with pytest.raises(ContractViolation, match=r"\[reward-shape\]"):
        ck.check_reward_fn(lambda f, a, p: f[:, 0] * w, E, F, A)


def test_row_count_rounding_reward_rejected():
    """A row-wise value whose rounding moves with the row count: each
    shard would compute other bits than the whole (env-gemm-rows)."""
    bad = lambda f, a, p: f[:, 0] * (1.0 + 1e-6 * f.shape[0])
    with pytest.raises(ContractViolation) as ei:
        RewardSpec((RewardTerm("custom", fn=bad),))
    assert _rules(ei.value.violations) == ["env-gemm-rows"]


def test_env_rules_scoped():
    """With ``Rules(env=False)`` a cross-env fn passes the probes (the
    unsharded engines may run it)."""
    ck.check_reward_fn(_centred, E, F, A, rules=ck.Rules(env=False))


def test_reward_spec_unchecked_escape_hatch(caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.core.reward"):
        RewardSpec((RewardTerm("custom", fn=_centred),), unchecked=True)
    assert "unchecked=True" in caplog.text


def test_unprobeable_custom_term_warns_not_raises():
    """A fn that indexes past every probe shape of the ladder is skipped
    with a warning; the system checks it at its true shapes."""
    with pytest.warns(UserWarning, match="could not check"):
        RewardSpec((RewardTerm("custom", fn=lambda f, a, p: f[:, 500]),))


# ------------------------------------------------------ callback-in-scan
def test_host_read_in_reward_rejected_and_good_twin_passes():
    bad = lambda f, a, p: f[:, 0] * float(f[0, 0])
    good = lambda f, a, p: f[:, 0] * f[:, 1]
    with pytest.raises(ContractViolation) as ei:
        RewardSpec((RewardTerm("custom", fn=bad),))
    assert _rules(ei.value.violations) == ["callback-in-scan"]
    assert "__float__" in str(ei.value)
    RewardSpec((RewardTerm("custom", fn=good),))


def _predictor(model=None, spec=None, capacity=8):
    from repro_torch.core.reward import energy_reward_spec
    return Predictor(model or linear_policy(F, A, device="cpu"),
                     spec or energy_reward_spec(1, 0, 0),
                     ActionSpace(np.full(A, -1.0), np.full(A, 1.0)), E, F,
                     replay_capacity=capacity, device="cpu")


def test_host_read_in_decide_step_rejected():
    """A policy that reads its features back (``.tolist()``) inside the
    decide step is refused in every fused build, sharded or not; the
    linear policy passes."""
    w = torch.ones((F, A)) / F

    def chatty(f):
        scale = max(f.abs().max(-1).values.tolist())
        return torch.tanh((f[..., :, None] * w).sum(-2) / scale)

    pred = _predictor(ModelAdapter(chatty, "chatty"))
    with pytest.raises(ContractViolation) as ei:
        ck.check_system(pred, pred.make_decide_fn(), pred.decide_state(),
                        sharded=False)
    assert _rules(ei.value.violations) == ["callback-in-scan"]
    assert "tolist" in str(ei.value)
    pred = _predictor()
    ck.check_system(pred, pred.make_decide_fn(), pred.decide_state(),
                    sharded=True)


# -------------------------------------------------------------- time-cast
def _with_tick_term(decide, term):
    """The decide step with ``term(tick)`` added to every reward."""
    def step(carry, feats):
        new, (a, r, pt, v), trans = decide.step(carry, feats)
        r = r + term(carry.tick)
        return new, (a, r, pt, v), trans[:2] + (r,) + trans[3:]
    return DecideFns(step, decide.bank)


def test_float32_cast_of_the_tick_rejected():
    """The half-tick offset survives at tick 0 and vanishes at 2^24 in
    float32: the absolute tick cast to float32 (the t ~ 2^24 collapse)."""
    pred = _predictor()
    bad = _with_tick_term(pred.make_decide_fn(),
                          lambda t: (t.float() + 0.5) - t.float())
    with pytest.raises(ContractViolation) as ei:
        ck.check_decide_fns(bad, pred.decide_state(), E, F,
                            rules=ck.Rules(env=False))
    assert _rules(ei.value.violations) == ["time-cast"]
    assert "2^24" in str(ei.value)


def test_integer_tick_arithmetic_is_clean():
    """Integer work on the tick (a phase whose period divides 2^24) and a
    rebased difference keep their bits."""
    pred = _predictor()
    for term in (lambda t: (t % 16).float() * 0.25,
                 lambda t: (t - t).float() + 0.5):
        good = _with_tick_term(pred.make_decide_fn(), term)
        ck.check_decide_fns(good, pred.decide_state(), E, F,
                            rules=ck.Rules(env=False))


def test_real_decide_fns_accepted_dense_and_elastic():
    pred = _predictor()
    ck.check_decide_fns(pred.make_decide_fn(), pred.decide_state(), E, F)
    el = pred.decide_state()._replace(active=torch.arange(E) < 2,
                                      prev_ok=torch.zeros(E, dtype=bool))
    ck.check_decide_fns(pred.make_decide_fn(), el, E, F)


# ------------------------------------------------------------ train step
def _train_fixture():
    """An empty ring, as at trainer construction: the check probes a
    seeded full ring of its layout."""
    buf = rp.init(E, 16, F, A, "cpu")
    params = {"w": torch.zeros(F, A)}
    tstate = {"m": {"w": torch.zeros(F, A)},
              "step": torch.zeros((), dtype=torch.int32)}
    return buf, params, tstate


def test_train_step_raw_tick_weighting_rejected():
    buf, params, tstate = _train_fixture()

    def bad(params, tstate, replay, es, ss):
        batch = rp.gather(replay, es, ss)
        w = batch["tick_idx"].float() + 0.5 - batch["tick_idx"].float()
        return torch.sum(w * batch["rewards"]) + params["w"].sum()

    with pytest.raises(ContractViolation) as ei:
        ck.check_train_step(bad, params, tstate, buf)
    assert _rules(ei.value.violations) == ["time-cast"]


def test_train_step_rebased_tick_weighting_and_batch_reduce_accepted():
    buf, params, tstate = _train_fixture()

    def good(params, tstate, replay, es, ss):
        batch = rp.gather(replay, es, ss)
        age = (batch["tick_idx"] - batch["tick_idx"][0]).float()
        w = torch.exp(-age.abs() / 100.0) * batch["valid"]
        err = torch.square(batch["actions"]).sum(-1)
        return torch.mean(w * err) + params["w"].sum()

    ck.check_train_step(good, params, tstate, buf)


def test_train_step_host_read_rejected():
    buf, params, tstate = _train_fixture()

    def chatty(params, tstate, replay, es, ss):
        batch = rp.gather(replay, es, ss)
        n = batch["valid"].sum().item()
        return torch.sum(batch["rewards"] * batch["valid"]) / max(n, 1)

    with pytest.raises(ContractViolation) as ei:
        ck.check_train_step(chatty, params, tstate, buf)
    assert _rules(ei.value.violations) == ["callback-in-scan"]


def test_real_trainer_step_accepted():
    """``OnlineTrainer(contract_check=True)`` (the default) checks its step
    at construction and passes."""
    pred = _predictor(capacity=16)
    trainer = OnlineTrainer(pred, batch_size=8)
    assert trainer.version == 0
    OnlineTrainer(pred, batch_size=8, contract_check=False)


def test_trainer_with_raw_tick_weighted_loss_refused(monkeypatch):
    """A trainer whose loss weights each row by its float32 ``tick_idx``
    is refused at construction, while its Predictor's ring is still empty
    (the step gates on valid rows, so only a filled probe ring shows the
    cast); with ``contract_check=False`` it builds."""
    from repro_torch.runtime import trainer as trainer_mod
    td_loss = trainer_mod.td_loss

    def tick_weighted(apply_fn, params, critic, batch, pi_coef=0.1):
        w = 1.0 + batch["tick_idx"].to(torch.float32) * 1e-3
        return td_loss(apply_fn, params, critic,
                       dict(batch, rewards=batch["rewards"] * w), pi_coef)

    monkeypatch.setattr(trainer_mod, "td_loss", tick_weighted)
    pred = _predictor(capacity=16)
    assert int(pred.replay.cursor) == 0
    with pytest.raises(ContractViolation) as ei:
        OnlineTrainer(pred, batch_size=8)
    assert _rules(ei.value.violations) == ["time-cast"]
    OnlineTrainer(pred, batch_size=8, contract_check=False)


def test_host_reads_restores_tensor_methods():
    saved = {m: getattr(torch.Tensor, m) for m in ck.host_reads.METHODS}
    with pytest.raises(ValueError):
        with ck.host_reads() as hr:
            torch.ones(2).tolist()
            raise ValueError("inside the probe")
    assert hr.calls == ["tolist"]
    assert all(getattr(torch.Tensor, m) is f for m, f in saved.items())


# -------------------------------------------------------------- builtins
def test_all_builtins_accepted():
    assert ck.check_builtins() >= 10


# ------------------------------------------------------------------ lint
def _lint_src(src, rel="src/repro_torch/fixture.py"):
    return lint_mod.lint_source(src, rel)


def test_lint_state_leaf_alias():
    bad = "norm = system.state.norm\n"
    good = "norm = system.snapshot_norm()\n"
    assert _rules(_lint_src(bad)) == ["state-leaf-alias"]
    assert _lint_src(good) == []
    assert _lint_src(bad, rel="src/repro_torch/runtime/system.py") == []


def test_lint_lock_multi_acquire():
    rt = "src/repro_torch/runtime/fixture.py"
    bad = ("def flush(self, items):\n"
           "    for it in items:\n"
           "        with self._lock:\n"
           "            self._emit(it)\n")
    good = ("def flush(self, items):\n"
            "    with self._lock:\n"
            "        for it in items:\n"
            "            self._emit(it)\n")
    nested = ("def flush(self):\n"
              "    with self._lock:\n"
              "        with self._lock:\n"
              "            pass\n")
    sibling = ("class Hub:\n"
               "    def emit(self, it):\n"
               "        with self._lock:\n"
               "            self.sink.append(it)\n"
               "    def flush(self, items):\n"
               "        with self._lock:\n"
               "            self.emit(items[0])\n")
    daemon = ("def pump(self):\n"
              "    while not self._stop:\n"
              "        with self._lock:\n"
              "            self._drain()\n")
    for src in (bad, nested, sibling):
        assert _rules(_lint_src(src, rel=rt)) == ["lock-multi-acquire"]
    assert _lint_src(good, rel=rt) == []
    assert _lint_src(daemon, rel=rt) == []
    assert _lint_src(bad) == []                 # outside runtime/


def test_lint_pragma_suppression():
    src = "norm = system.state.norm  # lint: allow[state-leaf-alias]\n"
    above = "# lint: allow[state-leaf-alias]\nnorm = system.state.norm\n"
    other = "norm = system.state.norm  # lint: allow[lock-multi-acquire]\n"
    assert _lint_src(src) == [] and _lint_src(above) == []
    assert _rules(_lint_src(other)) == ["state-leaf-alias"]


def test_repo_is_lint_clean():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
    n = int(out.stdout.split("lint: ")[1].split()[0])
    assert n > 80                     # the package and the port examples


def _lint_cli(capsys, *argv):
    """``lint.main`` with ``argv``: (exit code, its standard output)."""
    code = lint_mod.main(list(argv))
    return code, capsys.readouterr().out


def test_lint_baseline_grandfathers_by_fingerprint(tmp_path, capsys,
                                                   monkeypatch):
    """``--update-baseline`` records the findings by (rule, file, stripped
    code); they then pass, also after a line shift, while a new finding,
    ``--no-baseline`` and a missing baseline file (an empty one) fail."""
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "fixture.py"
    src.write_text("norm = system.state.norm\n")
    bl = str(tmp_path / "baseline.json")
    code, out = _lint_cli(capsys, str(src), "--baseline", bl,
                          "--update-baseline")
    assert code == 0 and "wrote 1 finding(s)" in out
    entry, = json.loads((tmp_path / "baseline.json").read_text())[
        "violations"]
    assert entry == {"rule": "state-leaf-alias", "file": "fixture.py",
                     "code": "norm = system.state.norm"}
    code, out = _lint_cli(capsys, str(src), "--baseline", bl)
    assert code == 0 and "0 finding(s), 1 baselined" in out
    src.write_text("\n\nnorm = system.state.norm\n")   # shifted
    assert _lint_cli(capsys, str(src), "--baseline", bl)[0] == 0
    src.write_text("norm = system.state.norm\nx = system.state.anomaly\n")
    code, out = _lint_cli(capsys, str(src), "--baseline", bl)
    assert code == 1 and "fixture.py:2: [state-leaf-alias]" in out
    assert "1 finding(s), 1 baselined" in out
    assert _lint_cli(capsys, str(src), "--baseline", bl,
                     "--no-baseline")[0] == 1
    code, out = _lint_cli(capsys, str(src), "--baseline",
                          str(tmp_path / "missing.json"))
    assert code == 1 and "2 finding(s), 0 baselined" in out


def test_lint_formats(tmp_path, capsys, monkeypatch):
    """``--format json``: the reference's document (files, new,
    baselined, elapsed_s, findings with rule, file, line, message,
    baselined, fingerprint); ``--format github``: one ``::error``
    workflow command per new finding, on its file and line."""
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "fixture.py"
    src.write_text("x = 1\nnorm = system.state.norm\n")
    bl = str(tmp_path / "none.json")
    code, out = _lint_cli(capsys, str(src), "--baseline", bl,
                          "--format", "json")
    doc = json.loads(out)
    assert code == 1
    assert {k: doc[k] for k in ("files", "new", "baselined")} == \
        {"files": 1, "new": 1, "baselined": 0}
    finding, = doc["findings"]
    assert {k: finding[k] for k in ("rule", "file", "line", "baselined")} \
        == {"rule": "state-leaf-alias", "file": "fixture.py", "line": 2,
            "baselined": False}
    assert finding["fingerprint"]["code"] == "norm = system.state.norm"
    code, out = _lint_cli(capsys, str(src), "--baseline", bl,
                          "--format", "github")
    lines = out.splitlines()
    assert code == 1 and [x for x in lines if x.startswith("::")] == \
        lines[:1]
    assert lines[0].startswith(
        "::error file=fixture.py,line=2,title=lint state-leaf-alias::")


def test_lint_builtins(tmp_path, capsys, monkeypatch):
    """``--builtins`` runs ``check_builtins`` (every registry policy
    certified) beside the lint; a failing builtin fails the command, in
    every format."""
    src = tmp_path / "clean.py"
    src.write_text("x = 1\n")
    code, out = _lint_cli(capsys, str(src), "--builtins")
    assert code == 0 and "builtin fns checked" in out
    n = int(out.split("baselined, ")[1].split()[0])
    assert n >= 10 + len(POLICIES)

    def broken(verbose=False):
        raise ContractViolation([], label="a broken builtin")
    monkeypatch.setattr(ck, "check_builtins", broken)
    code, out = _lint_cli(capsys, str(src), "--builtins")
    assert code == 1 and "builtin contract check FAILED" in out
    code, out = _lint_cli(capsys, str(src), "--builtins", "--format",
                          "json")
    assert code == 1 and "a broken builtin" in \
        json.loads(out)["builtins"]["error"]
    code, out = _lint_cli(capsys, str(src), "--builtins", "--format",
                          "github")
    assert code == 1 and out.startswith(
        "::error title=builtin contract check::")


def test_rule_catalogs():
    assert set(LINT_RULES) == {"state-leaf-alias", "lock-multi-acquire"}
    assert {"reward-shape", "callback-in-scan", "time-cast", "env-reduce",
            "env-gemm-rows", "carry-env-mix",
            "param-replication"} == set(RULES)
    assert lint_mod.main(["--list-rules"]) == 0


# ---------------------------------------------------------- import guard
def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports with ``jax`` and ``repro`` made
    unimportable (``sys.modules[name] = None``), as on the card's image."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro') and sys.modules[k])\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 60
