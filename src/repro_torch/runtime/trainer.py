"""OnlineTrainer — port of ``repro.runtime.trainer``: policy retraining on
the device, interleaved with the fused decide launches.

One train step per K-window batch samples a minibatch from the replay ring
in place (``replay.draw_device`` + ``replay.gather``), takes the gradient
of :func:`td_loss` by autograd and runs the repo's own AdamW
(``train.optimizer``). At each batch boundary:

    boundary j:   apply_pending()      # adopt step j-1's result, bump
                                       #   policy_version, swap the carry
                  decide launch j      # run_many_decide on carry j-1
                  dispatch(carry j)    # train step launched right AFTER
                                       #   decide j, on the same stream
    (host consumes batch j meanwhile)

Ordering: the step goes on the SAME stream as the decide launch, right
after it, as the reference's in-order device queue runs it. That order is
also what keeps batch j+1's in-place ``replay.add_batch`` from writing the
ring while step j still reads it. A side stream would need events both
ways (step after decide j, ``add_batch`` of j+1 after the step) and would
overlap nothing while one Python thread launches both.

Hot-swap: ``apply_pending`` replaces the carry's ``policy``/``version``
leaves between two launches only, never inside a batch. ``policy_version``
rises by one on every APPLIED step, and the decide path stamps the version
that produced each action into its replay row and LogDB row. The step and
the optimizer are pure (they return new tensors and write none of their
inputs), so the batch already launched on the old params is never changed
under it, and the carry, the Predictor's mirror and a checkpoint can share
the new params' tensors.

Empty ring: the draw gates rows on ``valid``, and the step gates every new
leaf on ``has_data`` with ``torch.where`` on the device, so a step launched
before the first transition banks is an exact no-op (no AdamW decay drift,
no step advance, no version bump).

Host reads: :meth:`OnlineTrainer.apply_pending` reads one scalar,
``has_data``, as the reference does; loss and grad norm stay on the device
until :meth:`OnlineTrainer.train_stats` reads them. The step itself reads
nothing back.

The reference checks the train step against its jaxpr contracts
(``contract_check``); the port certifies the policy only
(``analysis.certify``), and the train step's check waits for ROADMAP.md
queue 1 item 14, so there is no such argument here.

Sharded systems hand :meth:`OnlineTrainer.dispatch` shard 0's carry with
the shard rings as one sharded ring (a tuple, in row order): the draw
spans every row and ``replay.gather`` collects the minibatch from the
shards onto the first device, so the step equals the unsharded one bit
for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import replay as rp
from repro_torch.device import resolve_device
from repro_torch.runtime.predictor import policy_call
from repro_torch.train import optimizer as opt
from repro_torch.train import tree
from repro_torch.train.checkpoint import Checkpointer


def critic_init(n_features: int, n_actions: int, device=None) -> dict:
    """Linear reward critic ``Q(obs, act) = [obs; act] . w + b``, owned by
    the trainer (it never enters the decide carry), on ``device``
    (``None`` means the CUDA card)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return {"qw": torch.zeros((n_features + n_actions,), **f32),
            "qb": torch.zeros((), **f32)}


def critic_apply(critic, obs, actions):
    """The dot as multiply + sum (as every policy dot is): a reduction
    whose backward is a reduction too, with no library gemv in either."""
    x = torch.cat([obs, actions], dim=-1)
    return (x * critic["qw"]).sum(-1) + critic["qb"]


def td_loss(apply_fn, params, critic, batch, pi_coef: float = 0.1):
    """One-step TD/regression loss on a sampled minibatch: the critic's
    regression against the banked rewards, ``(Q(obs, banked_action) -
    reward)^2``, plus the policy-improvement term through the critic,
    ``-Q(obs, policy(obs))``. Each term is weighted by ``valid`` and
    divided by the valid count, floored at 1, so an all-invalid batch
    gives loss 0 with zero gradients."""
    v = batch["valid"].to(torch.float32)
    nv = torch.clamp(torch.sum(v), min=1.0)
    q_banked = critic_apply(critic, batch["obs"], batch["actions"])
    loss_q = torch.sum(v * torch.square(q_banked - batch["rewards"])) / nv
    a_pi = apply_fn(params, batch["obs"])
    loss_pi = -torch.sum(v * critic_apply(critic, batch["obs"], a_pi)) / nv
    return loss_q + pi_coef * loss_pi


def default_train_cfg(**overrides) -> TrainConfig:
    """Online-policy defaults: no warmup (the first applied step should
    move), no weight decay (a deployed policy must not drift toward zero
    while the ring is sparse)."""
    kw = dict(learning_rate=3e-4, warmup_steps=0, weight_decay=0.0)
    kw.update(overrides)
    return TrainConfig(**kw)


class OnlineTrainer:
    """Interleaves policy updates with the fused decide launches.

    Driven by ``PerceptaSystem`` at each batch boundary, in this order:

      * :meth:`apply_pending` BEFORE the decide launch: adopt the previous
        step's result; if it saw data, bump ``policy_version`` and return
        the carry with the new ``policy``/``version`` leaves (otherwise
        the carry unchanged). Also checkpoints every ``checkpoint_every``
        applied steps.
      * :meth:`dispatch` AFTER the decide launch: launch one step on the
        new carry's policy and replay ring.

    Standalone use (tests, the smoke): ``step_fn(params, train_state,
    replay, es, ss)`` is the update on the minibatch at (env ``es``, slot
    ``ss``), returning ``(new_params, new_train_state, loss, gnorm,
    has_data)``; :meth:`draw` gives the indices :meth:`dispatch` uses.
    A stateful policy raises here (``policy_call``).
    """

    def __init__(self, predictor, batch_size: int = 128,
                 train_cfg: Optional[TrainConfig] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0):
        apply_fn, params = policy_call(predictor.model)
        if not tree.leaves(params):
            raise ValueError(
                "online training needs a parameterized model: give the "
                "ModelAdapter params= and apply= (see linear_policy); "
                f"model '{predictor.model.name}' exposes no trainable "
                "params")
        self.predictor = predictor
        self.batch_size = int(batch_size)
        self.cfg = train_cfg if train_cfg is not None else default_train_cfg()
        self.device = predictor.device
        critic = critic_init(predictor.n_features,
                             predictor.action_space.n,
                             device=self.device)
        # the critic never rides the decide carry; one optimizer state
        # covers the joint {policy, critic} tree
        self.train_state = {
            "critic": critic,
            "opt": opt.init({"policy": params, "critic": critic}),
        }
        self.version = int(predictor.policy_version)
        self.stats = {"dispatched": 0, "applied": 0, "skipped_empty": 0,
                      "last_loss": None, "last_gnorm": None}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._pending = None
        self._apply_fn = apply_fn
        self._ckpt = None
        self.checkpoint_every = int(checkpoint_every)
        if checkpoint_dir is not None:
            self._ckpt = Checkpointer(checkpoint_dir,
                                      keep=self.cfg.keep_checkpoints,
                                      async_mode=self.cfg.async_checkpoint)

    # --- the step ------------------------------------------------------------

    def draw(self, replay):
        """The next minibatch's ``(es, ss)``, drawn on the device."""
        return rp.draw_device(replay, self._gen, self.batch_size)

    def step_fn(self, params, tstate, replay, es, ss):
        batch = rp.gather(replay, es, ss)
        # any() not [0]: a cell can be invalid while the ring has data
        has_data = torch.any(batch["valid"])
        joint = {"policy": params, "critic": tstate["critic"]}
        flat, treedef = tree.flatten(joint)
        # the system launches decide under no_grad; the step needs grad
        with torch.enable_grad():
            live = [x.detach().requires_grad_() for x in flat]
            j = tree.unflatten(treedef, live)
            loss = td_loss(self._apply_fn, j["policy"], j["critic"], batch)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            new_joint, new_opt, gnorm = opt.update(
                tree.unflatten(treedef, list(grads)), tstate["opt"], joint,
                self.cfg)
            # with an empty ring the gradients are zero, but AdamW's decay
            # and step advance would still move the state: gate every leaf
            gate = lambda new, old: tree.map_(
                lambda a, b: torch.where(has_data, a, b), new, old)
            new_tstate = {"critic": gate(new_joint["critic"],
                                         tstate["critic"]),
                          "opt": gate(new_opt, tstate["opt"])}
            loss = torch.where(has_data, loss.detach(),
                               torch.zeros_like(loss))
            return (gate(new_joint["policy"], params), new_tstate, loss,
                    gnorm, has_data)

    # --- batch-boundary protocol ---------------------------------------------

    def apply_pending(self, dstate):
        """Adopt the launched step's result; swap the carry at the boundary.

        Reads one scalar (``has_data``) on the host: the step was launched
        right behind the previous decide batch, which has since been
        consumed, so the wait is for the step alone. Returns ``dstate``
        with the new ``policy``/``version`` leaves when the step applied,
        unchanged otherwise. The optimizer state is adopted either way (an
        empty-ring step returns its input bits)."""
        if self._pending is None:
            return dstate
        new_params, new_tstate, loss, gnorm, has_data = self._pending
        self._pending = None
        self.train_state = new_tstate
        if not bool(has_data):
            self.stats["skipped_empty"] += 1
            return dstate
        self.stats["applied"] += 1
        self.stats["last_loss"], self.stats["last_gnorm"] = loss, gnorm
        self.version += 1
        self.predictor.adopt_policy(new_params, self.version)
        self._maybe_checkpoint(new_params)
        return dstate._replace(policy=new_params, version=torch.tensor(
            self.version, dtype=torch.int32, device=self.device))

    def dispatch(self, dstate) -> None:
        """Launch one step behind the decide batch that produced
        ``dstate`` (it reads the carry's policy and ring, writes neither)."""
        es, ss = self.draw(dstate.replay)
        self._pending = self.step_fn(dstate.policy, self.train_state,
                                     dstate.replay, es, ss)
        self.stats["dispatched"] += 1

    def flush_pending(self, dstate):
        """Adopt the launched step now (end of run / before export)."""
        return self.apply_pending(dstate)

    # --- checkpointing -------------------------------------------------------

    def _maybe_checkpoint(self, params) -> None:
        if self._ckpt is None or self.checkpoint_every <= 0:
            return
        if self.stats["applied"] % self.checkpoint_every == 0:
            self._ckpt.save(
                self.stats["applied"],
                {"params": params, "train": self.train_state},
                extra={"policy_version": self.version,
                       "applied": self.stats["applied"]})

    def save_checkpoint(self, block: bool = True) -> int:
        """Snapshot policy + optimizer state now; returns the step saved
        at."""
        if self._ckpt is None:
            raise ValueError("OnlineTrainer built without checkpoint_dir")
        step = self.stats["applied"]
        self._ckpt.save(step,
                        {"params": self.predictor.policy_params,
                         "train": self.train_state},
                        extra={"policy_version": self.version,
                               "applied": step},
                        block=block)
        return step

    def restore_latest(self):
        """Restore the newest policy + optimizer snapshot into the trainer
        and the Predictor's mirror; returns ``(step, params, extra)``, or
        None when there is no checkpoint. The HOST side only: a running
        fused system serves from its carry, so use
        ``PerceptaSystem.restore_training()``, which also swaps the
        restored leaves into the carry."""
        if self._ckpt is None:
            raise ValueError("OnlineTrainer built without checkpoint_dir")
        self._ckpt.flush()
        step = self._ckpt.latest_step()
        if step is None:
            return None
        # a launched step trained on the pre-restore weights: discard it
        self._pending = None
        like = {"params": self.predictor.policy_params,
                "train": self.train_state}
        t, extra = self._ckpt.restore(step, like)
        self.train_state = t["train"]
        self.version = int(extra.get("policy_version", self.version))
        self.stats["applied"] = int(extra.get("applied",
                                              self.stats["applied"]))
        self.predictor.adopt_policy(t["params"], self.version)
        return step, t["params"], extra

    def close(self) -> None:
        if self._ckpt is not None:
            self._ckpt.close()

    def train_stats(self) -> dict:
        """The counters, the last applied step's loss and grad norm (read
        from the device here, not per step) and the current version."""
        out = {k: float(v) if isinstance(v, torch.Tensor) else v
               for k, v in self.stats.items()}
        return dict(out, version=self.version)
