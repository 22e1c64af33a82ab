"""LM training loop: checkpoint/restart, preemption, straggler policy,
metrics — port of ``repro.train.loop``, on a mesh (one device: (1, 1)).

The machinery lives elsewhere: ``launch.steps.build_train_step`` (the
step), ``train.checkpoint.Checkpointer`` (fault tolerance),
``data.pipeline.Prefetcher`` (overlapped input), and here
:class:`StragglerPolicy` / :class:`PreemptionGuard` (mitigation).

Restore picks the newest complete checkpoint (``latest_step``) and
resumes the data stream at the cursor saved with it, so a run of N steps
equals a run of k steps, a crash, and a restored run to N, loss for loss.
A fresh run draws its weights from ``tcfg.seed`` (``LM``'s generator on
the device) and starts AdamW from zeros.

The checkpoints keep the port's layout (``LM.params``: one entry per
layer, plus AdamW's ``m``, ``v`` and ``step`` over the same tree),
gathered to global tensors whatever mesh trained them. They
do not restore into the reference, whose layers are stacked into pattern
groups; ``convert.lm_train_state_from_numpy`` carries a reference state
the other way.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      ShardingConfig, TrainConfig)
from repro_torch.data.pipeline import (Prefetcher, StreamCursor,
                                       SyntheticLMStream)
from repro_torch.distribution import sharding as shd
from repro_torch.launch.steps import build_train_step
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tr
from repro_torch.train.checkpoint import Checkpointer


@dataclass
class StragglerPolicy:
    """EWMA step-time deadline detector: a step slower than ``k`` x the
    EWMA is ``slow``; ``consecutive_to_fail`` slow steps in a row are
    ``fail`` (checkpoint, and at scale drop the host and restart). The
    first ``min_steps`` steps only seed the EWMA."""
    k: float = 3.0                 # deadline = k * ewma
    alpha: float = 0.2
    consecutive_to_fail: int = 3
    min_steps: int = 5
    ewma: float = 0.0
    steps: int = 0
    strikes: int = 0
    slow_events: int = 0

    def observe(self, step_time_s: float) -> str:
        """Returns 'ok' | 'slow' | 'fail' (fail => trigger restart)."""
        self.steps += 1
        if self.steps <= self.min_steps:
            self.ewma = step_time_s if self.ewma == 0.0 else \
                (1 - self.alpha) * self.ewma + self.alpha * step_time_s
            return "ok"
        verdict = "ok"
        if step_time_s > self.k * max(self.ewma, 1e-9):
            self.strikes += 1
            self.slow_events += 1
            verdict = "slow"
            if self.strikes >= self.consecutive_to_fail:
                verdict = "fail"
        else:
            self.strikes = 0
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        return verdict


@dataclass
class PreemptionGuard:
    """SIGTERM-aware: cloud preemption sends SIGTERM before the kill."""
    triggered: bool = False

    def install(self):
        import signal

        def handler(signum, frame):
            self.triggered = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not the main thread (tests)
        return self


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list
    step_times: list
    restored_from: Optional[int]
    preempted: bool = False
    straggler_events: int = 0


def _split(shards):
    """Per-shard ``(params, opt_state)`` pairs -> (params per shard,
    opt_state per shard)."""
    return tuple(s[0] for s in shards), tuple(s[1] for s in shards)


def train(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
          perf: ShardingConfig = ShardingConfig(),
          tcfg: TrainConfig = TrainConfig(), device=None,
          max_steps: Optional[int] = None, stream_seed: int = 0,
          on_step: Optional[Callable[[int, dict], None]] = None,
          checkpointer: Optional[Checkpointer] = None) -> TrainResult:
    """Train ``cfg`` on the synthetic stream at ``shape`` until
    ``tcfg.total_steps`` (or ``max_steps``), checkpointing every
    ``tcfg.checkpoint_every`` steps, at the end, on preemption and on a
    straggler ``fail``. Reads one scalar (the loss) back per step, as the
    reference does.

    ``mesh``: a ``launch.mesh.ModelMesh`` to train on with ``perf`` (the
    step of ``launch.steps``); ``None`` is (1, 1) over ``device``, ``None``
    meaning the card. The state lives in the step's layouts, one tree per
    shard, each batch is split over the data axes by the prefetcher,
    checkpoints hold the gathered global trees, and a restore places them
    on this mesh, whichever mesh saved them. The model keeps the weights
    it was built with; the trained ones are the state's."""
    step_fn, model = build_train_step(cfg, shape, tcfg, device, mesh=mesh,
                                      perf=perf)
    mesh = model.mesh
    ckpt = checkpointer or Checkpointer(tcfg.checkpoint_dir,
                                        keep=tcfg.keep_checkpoints,
                                        async_mode=tcfg.async_checkpoint)
    guard = PreemptionGuard().install()
    straggler = StragglerPolicy()

    params = tr.map_(lambda x: x.detach(), model.params())
    opt_state = opt_lib.init(params)
    layouts = step_fn.layouts
    state_specs = [layouts["params"], layouts["opt"]]

    def place(batch):
        return shd.place_tree(batch, layouts["batch"](batch), mesh)

    cursor = StreamCursor()
    restored_from = None
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, extra = ckpt.restore(latest, (params, opt_state),
                                    (state_specs, mesh))
        params, opt_state = _split(state)
        cursor = StreamCursor.from_dict(extra.get("cursor", {}))
        start_step = restored_from = latest
    else:
        params, opt_state = _split(shd.place_tree(
            (params, opt_state), state_specs, mesh, copy=True))

    stream = SyntheticLMStream(cfg.vocab_size, shape.global_batch,
                               shape.seq_len, seed=stream_seed,
                               frontend=cfg.frontend, d_model=cfg.d_model,
                               n_patches=cfg.n_patches)
    prefetch = Prefetcher(stream, cursor, device=mesh.device(0), place=place)

    total = max_steps if max_steps is not None else tcfg.total_steps
    losses, times = [], []
    step = start_step
    preempted = False
    while step < total:
        batch = prefetch.next()
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        step += 1
        losses.append(loss)
        times.append(dt)
        verdict = straggler.observe(dt)
        if on_step:
            on_step(step, {**{k: float(v) for k, v in metrics.items()},
                           "time_s": dt, "straggler": verdict})
        should_ckpt = (step % tcfg.checkpoint_every == 0) or step == total
        if guard.triggered or verdict == "fail":
            should_ckpt = True
        if should_ckpt:
            # the cursor of the NEXT batch to train on (the prefetcher has
            # advanced past the one just used), the state gathered
            state = shd.gather_tree(tuple(zip(params, opt_state)),
                                    state_specs, mesh)
            ckpt.save(step, state,
                      extra={"cursor": cursor.state_dict(), "loss": loss})
        if guard.triggered:
            preempted = True
            break
        if verdict == "fail":
            # at scale: drop the slow host and re-mesh. In one process the
            # event is recorded and the run goes on
            straggler.strikes = 0
    ckpt.flush()
    return TrainResult(steps_run=step - start_step, final_step=step,
                       losses=losses, step_times=times,
                       restored_from=restored_from, preempted=preempted,
                       straggler_events=straggler.slow_events)
