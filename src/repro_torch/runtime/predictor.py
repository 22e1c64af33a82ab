"""Predictor — port of ``repro.runtime.predictor``: routes features to the
decision model, validates actions, computes rewards and banks replay
transitions.

Three consume paths:

  * :meth:`Predictor.on_tick` — one window. The per-window reference path.
  * :meth:`Predictor.on_windows` — a K-window stack: the policy and action
    validation run once per window on exactly the per-window (E, F) shapes
    (threading a recurrent model carry as K sequential steps would), the
    ``prev_obs``/``prev_actions`` chain materializes as shifted stacks,
    reward terms evaluate K-leading in one shot (elementwise, see
    ``RewardSpec.compute``) and the K transitions append through
    ``replay.add_many`` (K sequential ring writes). Outputs are
    bit-identical to K sequential ``on_tick`` calls.

  * :meth:`Predictor.make_decide_fn` — the fused path
    (``mode="scan_fused_decide"``): a per-window decision step that
    ``core.pipeline.run_many_decide`` calls inside its K loop, with the
    decision state (:class:`DecideState`) carried on the device, and one
    ``replay.add_batch`` per batch after the loop. The step runs exactly
    the per-window ops of :meth:`on_tick`, so its outputs equal both other
    paths bit for bit.

Long-horizon time rule: the replay ring stores the exact int32 tick index;
absolute float64 tick times are mirrored host-side in ``_replay_times``
and re-attached by :meth:`export_replay`.

Elastic slot pools: every consume path takes the (E,) bool ``active`` and
``prev_ok`` masks (``DecideState.active``/``prev_ok`` on the fused path).
Outputs are zeroed on inactive rows by ``torch.where`` and replay rows are
marked valid only where a live env closes a real prev -> next pair;
:meth:`clear_env_rows` and :meth:`grow_envs` are the attach/detach and
regrow hooks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import replay as rp
from repro_torch.core.reward import RewardSpec, validate_actions
from repro_torch.device import resolve_device


@dataclass
class ActionSpace:
    low: np.ndarray
    high: np.ndarray

    @property
    def n(self):
        return len(self.low)


class DecideState(NamedTuple):
    """The fused engine's decision carry, on the device.

    ``tick`` is the exact int32 predictor tick index of the next window;
    ``have_prev`` the () bool that gates the batch's first transition;
    ``version``/``prev_version`` the policy versions of this batch's
    actions and of ``prev_actions``. ``policy`` holds the live policy
    params (``{}`` for closure-only models), ``carry`` the recurrent model
    state of a stateful policy (``None`` otherwise). ``replay`` is the
    ring: it stays out of the K loop and is written once per batch by
    :class:`DecideFns`' ``bank``.

    ``active``/``prev_ok`` are the elastic slot-pool masks, (E,) bool
    device tensors (``None`` for a dense system): ``active`` marks the
    slots live this batch, ``prev_ok`` the slots that have produced a
    window since they last attached (the per-env twin of ``have_prev``).
    The host rewrites them in place between batches, never per row from
    Python values, so a membership change keeps every shape and tensor.
    """
    prev_obs: torch.Tensor      # (E, F)
    prev_actions: torch.Tensor  # (E, A)
    have_prev: torch.Tensor     # () bool
    tick: torch.Tensor          # () int32
    replay: rp.ReplayBuffer
    policy: dict
    version: torch.Tensor       # () int32
    prev_version: torch.Tensor  # () int32
    carry: object = None
    active: Optional[torch.Tensor] = None   # (E,) bool slot mask
    prev_ok: Optional[torch.Tensor] = None  # (E,) bool per-env have-prev


class DecideFns(NamedTuple):
    """The fused engine's decision protocol (see ``make_decide_fn``).

    ``step(DecideState, FeatureFrame) -> (DecideState, (actions, reward,
    per_term, violated), transition)`` runs one window's decision math;
    ``transition`` is the ``(prev_obs, prev_actions, reward, next_obs,
    tick, version, have_prev)`` row the window banks. ``bank(ReplayBuffer,
    stacked transitions, env_mask=None) -> ReplayBuffer`` writes the K
    stacked rows after the loop (``replay.add_batch``); ``env_mask`` (K, E)
    bool is the elastic row liveness that lands in ``valid``."""
    step: Callable
    bank: Callable


class ModelAdapter:
    """Wraps a policy fn(features (E, F)) -> actions (E, A).

    Parameterized models expose ``params`` (a dict of tensors) and
    ``apply(params, features)``. Recurrent models expose
    ``apply_carry(params, features, carry) -> (actions, new_carry)`` and
    ``init_carry(n_envs)``; their ``fn`` may be None. ``module`` holds the
    ``nn.Module`` of a policy that is one. ``certificate`` holds the
    ``analysis.certify.PolicyCertificate`` the registry attaches (None
    until a policy is certified).
    """

    def __init__(self, fn: Optional[Callable], name: str = "policy",
                 params=None, apply: Optional[Callable] = None,
                 apply_carry: Optional[Callable] = None,
                 init_carry: Optional[Callable] = None, module=None):
        if apply_carry is not None and init_carry is None:
            raise ValueError(
                f"stateful policy '{name}': apply_carry requires "
                "init_carry(n_envs)")
        self.fn = fn
        self.name = name
        self.params = params
        self.apply = apply
        self.apply_carry = apply_carry
        self.init_carry = init_carry
        self.module = module
        self.certificate = None

    def __call__(self, features):
        if self.fn is None:
            raise TypeError(
                f"policy '{self.name}' is stateful (apply_carry) and has no "
                "stateless fn view — route it through a Predictor")
        return self.fn(features)


def policy_call(model):
    """``(apply_fn, params)`` view of a STATELESS model: parameterized
    adapters route their weights explicitly, closure-only models get an
    empty params dict and an apply that ignores it.

    Stateful (``apply_carry``) models are rejected: callers of this view
    (the online trainer's step) cannot thread a recurrent carry, so a
    carry-less apply would silently re-run the policy from blank state
    every call."""
    if getattr(model, "apply_carry", None) is not None:
        raise ValueError(
            f"policy '{getattr(model, 'name', model)}' is stateful "
            "(apply_carry): the stateless (apply, params) view cannot "
            "thread its recurrent carry — use policy_call2 / the decide "
            "paths; online retraining (train='online') supports stateless "
            "policies only")
    if getattr(model, "apply", None) is not None \
            and getattr(model, "params", None) is not None:
        return model.apply, model.params
    return (lambda params, feats: model(feats)), {}


def policy_call2(model):
    """``(apply2, params, init_carry)`` view — the carry-capable calling
    convention both consume paths use: ``apply2(params, features, carry)
    -> (actions, new_carry)``. Stateless models pass ``None`` through as
    their carry."""
    if getattr(model, "apply_carry", None) is not None:
        params = getattr(model, "params", None)
        return model.apply_carry, ({} if params is None else params), \
            model.init_carry
    if getattr(model, "apply", None) is not None \
            and getattr(model, "params", None) is not None:
        apply_fn, params = model.apply, model.params
    else:
        apply_fn, params = (lambda p, feats: model(feats)), {}

    def apply2(p, feats, carry):
        return apply_fn(p, feats), carry

    return apply2, params, None


def rowwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` (tanh, sigmoid, silu, exp...),
    each element rounded the same whatever the tensor's length, so a row's
    bits never depend on the number of env rows. On the CPU, PyTorch's
    vectorized kernels compute the last ``len % (2 x vector width)``
    elements of a tensor with scalar code, which rounds sigmoid, silu and
    softplus an ulp apart from the vector code: a pool of E slots and a
    dense system of fewer rows then gave a live row different bits. Here
    the CPU computes over a copy padded to a multiple of 64 elements (no
    scalar tail at any vector width). The card computes every element
    with the same code, so CUDA tensors go straight through."""
    if x.is_cuda:
        return fn(x)
    flat = x.reshape(-1)
    n = flat.numel()
    return fn(torch.nn.functional.pad(flat, (0, -n % 64)))[:n] \
        .reshape(x.shape)


def linear_policy(n_features: int, n_actions: int, seed: int = 0,
                  low=-1.0, high=1.0, *, params=None,
                  device=None) -> ModelAdapter:
    """A small deterministic policy standing in for the deployed RL model.

    ``device=None`` means the CUDA card (``resolve_device``).

    ``params={"w": (F, A)}`` loads given weights (e.g. the reference's,
    through ``convert.policy_params_from_numpy``); without it the weights
    are drawn from ``torch.Generator().manual_seed(seed)`` — different
    numbers from the reference's JAX generator at the same seed.
    """
    device = resolve_device(device)
    if params is None:
        g = torch.Generator().manual_seed(seed)
        w = torch.randn((n_features, n_actions), generator=g) \
            / n_features ** 0.5
        params = {"w": w.to(device)}

    # multiply + sum over F, not ``@``: the add order then depends only on F,
    # never on the number of env rows
    def apply(params, feats):
        logits = (feats[..., :, None] * params["w"]).sum(-2)
        return rowwise(torch.tanh, logits) * (high - low) / 2 \
            + (high + low) / 2

    return ModelAdapter(lambda feats: apply(params, feats), "linear_policy",
                        params=params, apply=apply)


class Predictor:
    """``device=None`` means the CUDA card; every tensor the Predictor
    owns (replay ring, prev carry, model carry) lives there."""

    def __init__(self, model, reward_spec: RewardSpec,
                 action_space: ActionSpace, n_envs: int, n_features: int,
                 db=None, replay_capacity: int = 4096, device=None):
        self.device = resolve_device(device)
        self.reward_spec = reward_spec
        self.action_space = action_space
        self.n_envs = n_envs
        self.n_features = n_features
        self.db = db
        self.replay = rp.init(n_envs, replay_capacity, n_features,
                              action_space.n, device=self.device)
        # host float64 absolute-time mirror, slot-aligned with the ring:
        # the transition written at cursor c (tick index c+1) lives in slot
        # c % capacity of both
        self._replay_times = np.zeros((replay_capacity,), np.float64)
        self._prev = {
            "obs": torch.zeros((n_envs, n_features), dtype=torch.float32,
                               device=self.device),
            "actions": torch.zeros((n_envs, action_space.n),
                                   dtype=torch.float32, device=self.device),
            "have": False,
            "version": 0,  # policy_version that produced prev_actions
        }
        self.stats = {"ticks": 0, "violations": 0}
        self.policy_version = 0
        self._low = torch.as_tensor(action_space.low, dtype=torch.float32,
                                    device=self.device)
        self._high = torch.as_tensor(action_space.high, dtype=torch.float32,
                                     device=self.device)
        self.set_model(model)

    def set_model(self, model) -> None:
        """Bind (or rebind) the decision model: a :class:`ModelAdapter`, a
        registry name or a ``runtime.policies.PolicyConfig``. Rebinding
        resets the recurrent model carry to its ``init_carry`` state."""
        from repro_torch.runtime.policies import PolicyConfig, build_policy
        if isinstance(model, (str, PolicyConfig)):
            model = build_policy(model, self.n_features,
                                 self.action_space.n, self.n_envs,
                                 device=self.device)
        self.model = model
        self._apply2, self.policy_params, init_carry = policy_call2(model)
        self._model_carry = (init_carry(self.n_envs)
                             if init_carry is not None else None)

    def _decide(self, features, mcarry):
        actions, mcarry = self._apply2(self.policy_params, features, mcarry)
        actions, violated = validate_actions(actions, self._low, self._high)
        return actions, violated, mcarry

    def _mask(self, x):
        """An (E,) bool host or device mask as a device tensor (None
        passes through)."""
        return None if x is None else torch.as_tensor(
            x, device=self.device).to(torch.bool)

    # --- fused decision path (mode="scan_fused_decide") --------------------
    def decide_state(self) -> DecideState:
        """The current decision state as the fused engine's device carry.

        Torch donates nothing, so the carry ALIASES this Predictor's
        tensors: ``replay`` is ``self.replay`` itself, which
        ``replay.add_batch`` then writes in place (ring and cursor), and
        ``prev_obs``/``prev_actions``/``carry`` are the current tensors.
        From here on the carry the caller threads is authoritative: this
        Predictor's ring follows it (same storage), but its ``_prev``,
        ``_model_carry`` and consume paths do not, so a fused system reads
        the ring through ``PerceptaSystem.snapshot_decide`` /
        ``export_replay`` and never calls :meth:`on_tick` or
        :meth:`on_windows` again."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return DecideState(
            prev_obs=self._prev["obs"],
            prev_actions=self._prev["actions"],
            have_prev=torch.tensor(bool(self._prev["have"]),
                                   device=self.device),
            tick=torch.tensor(self.stats["ticks"], **i32),
            replay=self.replay,
            policy=self.policy_params,
            version=torch.tensor(self.policy_version, **i32),
            prev_version=torch.tensor(self._prev["version"], **i32),
            carry=self._model_carry,
        )

    def adopt_policy(self, params, version: int) -> None:
        """Sync the host-side policy mirror after a hot-swap of the fused
        carry's ``policy``/``version`` leaves (the live weights travel in
        ``DecideState.policy``; this keeps ``policy_params``,
        ``policy_version`` and any later :meth:`decide_state` consistent
        with the carry)."""
        self.policy_params = params
        if getattr(self.model, "params", None) is not None:
            self.model.params = params
        self.policy_version = int(version)

    def make_decide_fn(self) -> DecideFns:
        """Decision protocol for the fused pipeline loop (:class:`DecideFns`).

        ``step`` runs exactly :meth:`on_tick`'s per-window ops (the policy
        on the (E, F) features, ``validate_actions``, the reward against
        the carried prev actions) and emits the window's transition at the
        carried device ``tick``: nothing in it reads a device value on the
        host. ``bank`` writes the K stacked transitions in one
        ``replay.add_batch`` (guarded by the carried ``have_prev`` chain),
        bit-identical to K guarded sequential ``add`` calls. With the
        elastic masks in the carry, ``step`` zeroes its outputs on
        inactive rows (``torch.where``: live rows keep their bits)."""
        apply2, spec = self._apply2, self.reward_spec
        # the envelope and the True scalar on each device a step runs on
        # (the shards of a sharded engine may sit on other cards)
        consts = {}

        def on(dev):
            if dev not in consts:
                consts[dev] = (self._low.to(dev), self._high.to(dev),
                               torch.ones((), dtype=torch.bool, device=dev))
            return consts[dev]

        def step(carry: DecideState, feats):
            low, high, true = on(feats.features.device)
            actions, new_mcarry = apply2(carry.policy, feats.features,
                                         carry.carry)
            actions, violated = validate_actions(actions, low, high)
            reward, per_term = spec.compute(feats.raw, actions,
                                            carry.prev_actions)
            if carry.active is not None:
                actions, reward, per_term, violated = _mask_outputs(
                    carry.active, actions, reward, per_term, violated)
            # the transition entering this window, attributed to the
            # version that produced its action
            transition = (carry.prev_obs, carry.prev_actions, reward,
                          feats.features, carry.tick, carry.prev_version,
                          carry.have_prev)
            new = carry._replace(prev_obs=feats.features,
                                 prev_actions=actions, have_prev=true,
                                 tick=carry.tick + 1,
                                 prev_version=carry.version,
                                 carry=new_mcarry)
            return new, (actions, reward, per_term, violated), transition

        def bank(replay, transitions, env_mask=None):
            obs, actions, rewards, next_obs, tick, version, mask = \
                transitions
            return rp.add_batch(replay, obs, actions, rewards, next_obs,
                                tick, mask, version, env_mask=env_mask)

        return DecideFns(step, bank)

    def absorb_fused(self, tick_times, violated) -> None:
        """Host bookkeeping after one fused batch: advance the tick and
        violation stats and the float64 time mirror in step with the device
        carry (``violated``: the batch's (K, E) host bools)."""
        self._record_times(self.stats["ticks"], tick_times)
        self.stats["ticks"] += len(tick_times)
        self.stats["violations"] += int(np.asarray(violated).sum())

    def _record_times(self, base_idx: int, tick_times) -> None:
        """Mirror absolute float64 tick times into the slot-aligned host
        ring (tick idx adds at cursor idx-1 -> slot (idx-1) % capacity)."""
        C = self._replay_times.shape[0]
        for j, t in enumerate(tick_times):
            idx = base_idx + j
            if idx >= 1:
                self._replay_times[(idx - 1) % C] = float(t)

    @torch.no_grad()
    def on_tick(self, features, tick_time, raw=None, active=None,
                prev_ok=None):
        """features: (E, F) device tensor; returns host actions, rewards
        and per-term rewards. The per-window reference path. ``active`` /
        ``prev_ok`` (E,) bool are the elastic slot-pool masks (None for a
        dense system)."""
        raw = features if raw is None else raw
        active, prev_ok = self._mask(active), self._mask(prev_ok)
        idx = self.stats["ticks"]
        actions, violated, self._model_carry = self._decide(
            features, self._model_carry)
        reward, per_term = self.reward_spec.compute(
            raw, actions, self._prev["actions"])
        if active is not None:
            actions, reward, per_term, violated = _mask_outputs(
                active, actions, reward, per_term, violated)
        if self._prev["have"]:
            rp.add(self.replay, self._prev["obs"], self._prev["actions"],
                   reward, features,
                   torch.tensor(idx, dtype=torch.int32),
                   self._prev["version"],
                   None if active is None else active & prev_ok)
        self._record_times(idx, [tick_time])
        self._prev = {"obs": features, "actions": actions, "have": True,
                      "version": self.policy_version}
        self.stats["ticks"] += 1
        self.stats["violations"] += int(violated.sum())
        return (actions.cpu().numpy(), reward.cpu().numpy(),
                per_term.cpu().numpy())

    @torch.no_grad()
    def on_windows(self, features, tick_times, raw=None, active=None,
                   prev_ok=None):
        """Consume a K-window stack. ``features``/``raw``: (K, E, F) (raw
        defaults to features); ``tick_times``: K absolute window-end times
        (host float64, never sent to the device). Returns host ``(actions
        (K, E, A), rewards (K, E), per_term (K, E, n_terms))`` —
        bit-identical to K sequential :meth:`on_tick` calls, replay
        contents and stats included. ``active``/``prev_ok`` (E,) bool are
        the elastic slot-pool masks (membership is constant within a
        batch)."""
        raw = features if raw is None else raw
        active, prev_ok = self._mask(active), self._mask(prev_ok)
        K = features.shape[0]
        if K < 1 or len(tick_times) != K:
            raise ValueError(f"on_windows: {K} windows, "
                             f"{len(tick_times)} tick times")
        base = self.stats["ticks"]
        acts, viols = [], []
        for k in range(K):
            a, v, self._model_carry = self._decide(features[k],
                                                   self._model_carry)
            acts.append(a)
            viols.append(v)
        actions = torch.stack(acts)
        violated = torch.stack(viols)
        if active is not None:
            # zero the inactive rows BEFORE the prev chain forms, so they
            # carry zeros into the shifted stack as on_tick's do
            actions = torch.where(active[:, None], actions, 0.0)
            violated = active & violated
        prev_act_seq = torch.cat([self._prev["actions"][None], actions[:-1]])
        rewards, per_term = self.reward_spec.compute(raw, actions,
                                                     prev_act_seq)
        env_mask = None
        if active is not None:
            rewards = torch.where(active, rewards, 0.0)
            per_term = torch.where(active[:, None], per_term, 0.0)
            # window 0 closes a pair begun in the last batch (prev_ok);
            # later windows need only active
            env_mask = torch.cat([(active & prev_ok)[None],
                                  active[None].expand(K - 1, -1)])
        # transition j stores (obs/actions entering window j, reward j,
        # next_obs = window j's features); only row 0 can lack a
        # predecessor, and only row 0's action can carry an earlier version
        prev_obs_seq = torch.cat([self._prev["obs"][None], features[:-1]])
        tick_idx = torch.arange(base, base + K, dtype=torch.int32)
        mask = [self._prev["have"]] + [True] * (K - 1)
        versions = [self._prev["version"]] + [self.policy_version] * (K - 1)
        rp.add_many(self.replay, prev_obs_seq, prev_act_seq, rewards,
                    features, tick_idx, mask, versions, env_mask)
        self._record_times(base, tick_times)
        self._prev = {"obs": features[-1], "actions": actions[-1],
                      "have": True, "version": self.policy_version}
        self.stats["ticks"] += K
        self.stats["violations"] += int(violated.sum())
        return (actions.cpu().numpy(), rewards.cpu().numpy(),
                per_term.cpu().numpy())

    def export_replay(self, env_ids, salt: str) -> dict:
        """Anonymized chronological replay export with exact float64
        absolute times re-attached from the host mirror (a sharded ring's
        shards gathered, rows in order)."""
        return rp.export_for_training(rp.whole(self.replay), env_ids, salt,
                                      slot_times=self._replay_times)

    # --- elastic slot-pool hooks (PerceptaSystem(elastic=True)) ------------
    def clear_env_rows(self, slots) -> None:
        """Scrub recycled slots (scan-mode attach/detach): zero their prev
        rows, reset their model-carry rows from ``init_carry`` and mark
        every replay cell of theirs invalid, so a later tenant never sees,
        or banks against, the departed env's transitions. The prev and
        carry rows are rewritten as new tensors (the old ones may be views
        of a batch's outputs); ``valid`` is written in place, as the ring
        always is, on the device's stream after the last batch's reads."""
        from repro_torch.distribution import elastic as el

        slots = [int(s) for s in np.asarray(slots).reshape(-1)]
        if not slots:
            return
        zeros = {"obs": torch.zeros_like(self._prev["obs"]),
                 "actions": torch.zeros_like(self._prev["actions"])}
        for k in zeros:
            self._prev[k] = el.reset_env_rows(self._prev[k], zeros[k],
                                              slots)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        self.replay.valid.index_fill_(0, idx, False)
        if self._model_carry is not None:
            self._model_carry = el.reset_env_rows(
                self._model_carry, self.model.init_carry(self.n_envs), slots)

    def grow_envs(self, n_envs_new: int) -> None:
        """Pad the env axis of every per-env structure (ring, prev rows,
        model carry) to ``n_envs_new`` slots (elastic pool regrow). New
        rows come from a fresh init template, never raw zeros where the
        init is not zero, and existing rows are copied bit for bit. The
        float64 time mirror is slot-aligned with the ring's capacity, not
        its env rows, so it carries over as it is."""
        from repro_torch.distribution import elastic as el

        old_e = self.n_envs
        if n_envs_new <= old_e:
            raise ValueError(f"grow_envs: {n_envs_new} slots, the pool has "
                             f"{old_e}")
        self.n_envs = n_envs_new
        self.replay = el.grow_env_tree(
            self.replay, rp.init(n_envs_new, self.replay.capacity,
                                 self.n_features, self.action_space.n,
                                 device=self.device), old_e)
        f32 = dict(dtype=torch.float32, device=self.device)
        for k, width in (("obs", self.n_features),
                         ("actions", self.action_space.n)):
            self._prev[k] = el.grow_env_tree(
                self._prev[k], torch.zeros((n_envs_new, width), **f32),
                old_e)
        if self._model_carry is not None:
            self._model_carry = el.grow_env_tree(
                self._model_carry, self.model.init_carry(n_envs_new), old_e)


def _mask_outputs(active, actions, reward, per_term, violated):
    """Zero a window's decision outputs on the inactive rows of ``active``
    (E,) bool, by ``torch.where``: live rows keep their bits."""
    return (torch.where(active[:, None], actions, 0.0),
            torch.where(active, reward, 0.0),
            torch.where(active[:, None], per_term, 0.0),
            active & violated)
