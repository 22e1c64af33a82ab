"""Contract checks of custom reward fns, the fused decide step and the
online train step, by behaviour — the port's counterpart of
``repro.analysis.jaxpr_check`` (same public names and, where torch allows,
the same signatures).

The reference traces each fn to a jaxpr and follows env and time
provenance through it without running it. PyTorch has no such program to
read, so each rule here is a probe that runs the fn on seeded inputs and
checks what the rule protects (rule ids in ``analysis.contracts``):

  * ``reward-shape``: a custom reward fn called at two env counts returns
    (E,) at each;
  * ``env-reduce`` / ``env-gemm-rows``: the rows probes of
    ``analysis.certify`` (:func:`~repro_torch.analysis.certify.rows_exchange`,
    ``rows_split``, ``rows_permute``), over a custom reward fn and over the
    whole decide step (``step``, and ``bank`` on a small probe ring). They
    bind where the reference's do: ``Rules(env=True)``, which
    :func:`check_system` sets in the sharded fused modes only (and
    :func:`check_reward_terms` at spec time). A carry leaf that moves
    between rows, or has no env dim, is ``carry-env-mix``, as there;
  * ``callback-in-scan``: a host read (``Tensor.cpu``, ``.item``,
    ``.tolist``, ``.numpy``, ``bool``/``int``/``float`` of a tensor) while
    the decide step, a reward fn or the train step runs. The reads are
    patched for the length of the probe, on the calling thread only, and
    restored in a ``finally``; on a card only reads of CUDA tensors count;
  * ``time-cast``: the fn run with its time inputs (the decide carry's
    int32 ``tick``, the replay's ``tick_idx`` for the train step) at
    t0 = 2^24 and at t0 = 0; every output that is not itself a time must
    keep its bits. A float32 cast of absolute time changes them; a rebased
    difference does not. A fn that uses the tick legitimately for a period
    passes only if the period divides 2^24, so such a fn would be refused:
    no builtin uses the tick so.

A probe sees only what its inputs exercise; it is no proof. Successful
system checks are cached by key, as ``certify`` caches certificates, since
every fused or sharded ``PerceptaSystem`` construction runs one.
"""
from __future__ import annotations

import threading
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import certify as cf
from repro_torch.analysis.contracts import ContractViolation, Violation
from repro_torch.train import tree as tr

TIME_SHIFT = 2 ** 24
LADDER = ((8, 4), (32, 8), (128, 16))
_CACHE: dict = {}
_CACHE_MAX = 256


class Rules(NamedTuple):
    """Whether a check enforces the env family: the rows probes (with
    ``carry-env-mix`` for a decide step's model carry), bound only where
    the decision math runs per shard. The callback and time families hold
    for every checked fn."""
    env: bool = True


class host_reads:
    """Counts host reads of tensors on this thread while open: every call
    of ``Tensor.cpu``, ``.item``, ``.tolist``, ``.numpy`` and ``bool`` /
    ``int`` / ``float`` of a tensor (of a CUDA tensor only, when
    ``cuda_only``). Patches ``torch.Tensor`` for the duration; restores it
    on exit."""
    METHODS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
               "__float__")

    def __init__(self, cuda_only: bool = False):
        self.cuda_only = cuda_only
        self.calls: list = []

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in self.METHODS}
        me = threading.get_ident()

        def wrap(name, orig):
            def run(t, *args, **kwargs):
                if threading.get_ident() == me and (t.is_cuda or
                                                    not self.cuda_only):
                    self.calls.append(name)
                return orig(t, *args, **kwargs)
            return run

        for m, orig in self._saved.items():
            setattr(torch.Tensor, m, wrap(m, orig))
        return self

    def __exit__(self, *exc):
        for m, orig in self._saved.items():
            setattr(torch.Tensor, m, orig)
        return False


def _reads(fn, device, add, what: str):
    """Run ``fn()`` under :class:`host_reads`, each read a
    ``callback-in-scan`` finding; return its result."""
    with host_reads(cuda_only=torch.device(device).type == "cuda") as hr:
        out = fn()
    if hr.calls:
        add("callback-in-scan",
            f"{what} reads tensors back to the host "
            f"({', '.join(sorted(set(hr.calls)))}; {len(hr.calls)} "
            "call(s)): a host sync inside the per-window loop")
    return out


def _raise_if(found, label: str) -> None:
    if found:
        raise ContractViolation(found, label)


def _normal(rng, shape, device):
    return torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(
        np.float32)).to(device)


def _leaves(out):
    return [x for x in tr.leaves(out) if isinstance(x, torch.Tensor)]


def _rows_family(call, rows, others, E, widths, perm, add, sized_rule,
                 what, full=None):
    """The three rows probes of ``certify`` over ``call`` (the exchange
    probe only where ``others`` is given); each finding goes to ``add``
    and ends the family."""
    full = call(rows) if full is None else full
    if others is not None and cf.rows_exchange(call, rows, others, full):
        add("env-reduce",
            f"{what}: rows exchange values — changing some rows' inputs "
            "changed the other rows' outputs (a reduction or contraction "
            "over the env axis)")
        return
    bad = cf.rows_split(call, rows, widths, full)
    if bad is not None:
        kind, w, blk, detail = bad
        if kind == "rounding":
            add("env-gemm-rows",
                f"{what}: rows {blk * w}..{(blk + 1) * w - 1} get other "
                f"bits in a call of {w} rows than in one of {E}: rounding "
                "depends on the row count")
        else:
            add(sized_rule,
                f"{what}: a call of a shard's {w} rows of E={E} fails or "
                f"returns other shapes ({detail}): something in it is "
                "sized by E")
        return
    if not cf.rows_permute(call, rows, perm, full):
        add("env-reduce",
            f"{what}: permuted rows do not give the permuted outputs — a "
            "row's result depends on its position among the rows")


def check_fn(fn: Callable, args: Sequence, *, rules: Rules = Rules(),
             label: str = "fn", shard_widths=None) -> list:
    """Probe ``fn(*args)``, every arg an (E, ...) tensor and every output
    leaf one too: the callback family on one call, the rows family over
    every arg when ``rules.env``. Returns the findings."""
    found: list = []
    add = lambda rule, msg: found.append(Violation(rule, msg, label))
    args = list(args)
    E = args[0].shape[0]
    device = args[0].device
    rng = np.random.RandomState(1)
    with torch.no_grad():
        _reads(lambda: fn(*args), device, add, label)
        if rules.env and not found:
            others = [_normal(rng, tuple(a.shape), device).to(a.dtype)
                      if a.is_floating_point() else None for a in args]
            widths = (cf.default_widths(E) if shard_widths is None
                      else tuple(shard_widths))
            _rows_family(lambda rows: _leaves(fn(*rows)), args, others, E,
                         widths, torch.from_numpy(rng.permutation(E)), add,
                         "env-reduce", label)
    return found


def check_policy(model, n_features: int, n_envs: int = 4, *,
                 rules: Rules = Rules(), label: Optional[str] = None,
                 device="cpu") -> None:
    """Check a policy (a ``ModelAdapter``, stateful or not) at (E, F): the
    callback family, and the rows family over features and carry when
    ``rules.env``. The carry is threaded as the consume paths thread it,
    so a recurrent policy is checked as it runs."""
    from repro_torch.runtime.predictor import policy_call2
    label = label or f"policy '{getattr(model, 'name', 'policy')}'"
    apply2, params, init_carry = policy_call2(model)
    carry = None if init_carry is None else init_carry(n_envs)
    c_flat, c_def = tr.flatten(carry)
    rng = np.random.RandomState(0)
    f = _normal(rng, (n_envs, n_features), torch.device(device))
    step = lambda f, *c: _leaves(apply2(params, f,
                                        tr.unflatten(c_def, list(c))))
    _raise_if(check_fn(step, [f] + c_flat, rules=rules, label=label), label)


def check_reward_fn(fn: Callable, n_envs: int, n_features: int,
                    n_actions: int, *, rules: Rules = Rules(),
                    label: str = "custom reward fn", device="cpu",
                    shard_widths=None) -> None:
    """Check a custom reward ``fn((E,F), (E,A), (E,A)) -> (E,)``: its
    shape at E and at E + 1 (``reward-shape``), then :func:`check_fn`."""
    device = torch.device(device)
    found: list = []
    for e_ in (n_envs, n_envs + 1):
        rng = np.random.RandomState(0)
        args = [_normal(rng, s, device) for s in
                ((e_, n_features), (e_, n_actions), (e_, n_actions))]
        try:
            with torch.no_grad():
                out = fn(*args)
        except (RuntimeError, ValueError, IndexError) as e:
            if e_ == n_envs:
                raise            # the probe shape itself does not fit
            found.append(Violation(
                "reward-shape",
                f"fails at E={e_} rows but runs at E={n_envs} "
                f"({type(e).__name__}: {str(e).splitlines()[0][:120]}): "
                "something in it is sized by the env count", label))
            break
        shape = tuple(getattr(out, "shape", ()))
        if shape != (e_,):
            found.append(Violation(
                "reward-shape",
                f"returns shape {shape} for (E={e_}, F={n_features}) "
                "features; the contract is one reward per env row: (E,)",
                label))
            break
    if not found:
        rng = np.random.RandomState(0)
        args = [_normal(rng, s, device) for s in
                ((n_envs, n_features), (n_envs, n_actions),
                 (n_envs, n_actions))]
        found = check_fn(fn, args, rules=rules, label=label,
                         shard_widths=shard_widths)
    _raise_if(found, label)


def check_reward_terms(terms, n_features: Optional[int] = None,
                       n_actions: Optional[int] = None, n_envs: int = 4, *,
                       rules: Rules = Rules(), device="cpu") -> None:
    """Check every ``custom`` term of a RewardSpec (duck-typed). Feature and
    action counts are unknown at spec construction, so the probe climbs
    the ladder ``LADDER`` when a fn indexes past a probe shape; a fn that
    runs at none is skipped with a warning (the system checks it again at
    its true shapes)."""
    ladder = ([(n_features, n_actions)]
              if n_features is not None and n_actions is not None
              else list(LADDER))
    for i, t in enumerate(terms):
        if getattr(t, "kind", None) != "custom" or t.fn is None:
            continue
        label = f"custom reward term #{i}"
        last_exc = None
        for F, A in ladder:
            try:
                check_reward_fn(t.fn, n_envs, F, A, rules=rules,
                                label=label, device=device)
                last_exc = None
                break
            except ContractViolation:
                raise
            except Exception as e:   # the probe shape is too small, etc.
                last_exc = e
        if last_exc is not None:
            warnings.warn(
                f"repro_torch.analysis: could not check {label} at probe "
                f"shapes {ladder}: {last_exc!r} — it will be checked at "
                "true shapes at system construction", stacklevel=2)


def _same_all(a, b) -> bool:
    return len(a) == len(b) and all(cf._same(x, y) for x, y in zip(a, b))


def check_decide_fns(decide, dstate, n_envs: int, n_features: int, *,
                     rules: Rules = Rules(), label: str = "decide",
                     shard_widths=None) -> None:
    """Check a ``DecideFns`` pair as the fused engine runs it: ``step`` on
    a seeded per-window ``FeatureFrame`` with ``dstate``'s policy, carry
    and masks (prev obs/actions and carry replaced by seeded values), and
    ``bank`` on a K-stack of transitions and a small probe ring of
    ``dstate``'s layout. Families: callbacks (step), time (step: the
    carry's ``tick``; bank: the transitions' tick column), and with
    ``rules.env`` the rows family over both and ``carry-env-mix`` over the
    model carry. Nothing of ``dstate`` is written."""
    from repro_torch.core import replay as rp
    from repro_torch.core.frame import FeatureFrame

    E, F = n_envs, n_features
    dev = dstate.prev_obs.device
    rng = np.random.RandomState(0)
    found: list = []
    add = lambda rule, msg: found.append(Violation(rule, msg, label))
    A = dstate.prev_actions.shape[-1]
    elastic = dstate.active is not None
    noise = lambda t: (_normal(rng, tuple(t.shape), dev).to(t.dtype)
                       if t.is_floating_point() else t)
    base = dstate._replace(
        replay=None, prev_obs=_normal(rng, (E, F), dev),
        prev_actions=_normal(rng, (E, A), dev),
        have_prev=torch.ones((), dtype=torch.bool, device=dev),
        carry=tr.map_(noise, dstate.carry))
    frame = [_normal(rng, (E, F), dev), _normal(rng, (E, F), dev),
             torch.rand((E,), generator=torch.Generator().manual_seed(0))
             .to(dev), _normal(rng, (E,), dev)]
    c_flat, c_def = tr.flatten(base.carry)
    masks = [base.active, base.prev_ok] if elastic else []
    n_c = len(c_flat)

    def build(rows, tick=None):
        po, pa = rows[0], rows[1]
        carry = tr.unflatten(c_def, rows[2:2 + n_c])
        m = rows[2 + n_c:2 + n_c + len(masks)]
        st = base._replace(prev_obs=po, prev_actions=pa, carry=carry)
        if elastic:
            st = st._replace(active=m[0], prev_ok=m[1])
        if tick is not None:
            st = st._replace(tick=tick)
        return st, FeatureFrame(*rows[2 + n_c + len(masks):])

    def run(rows, tick=None):
        with torch.no_grad():
            return decide.step(*build(rows, tick))

    def step_rows(out):
        new, outs, trans = out
        return ([new.prev_obs, new.prev_actions] + tr.leaves(new.carry)
                + list(outs) + list(trans[:4]))

    def step_rest(out):
        new, _, trans = out
        return [new.have_prev, new.version, new.prev_version, trans[5],
                trans[6]]

    rows = [base.prev_obs, base.prev_actions] + c_flat + masks + frame
    out0 = _reads(lambda: run(rows), dev, add, f"{label}.step")
    out1 = run(rows, base.tick + TIME_SHIFT)
    moved = (step_rows(out0) + step_rest(out0),
             step_rows(out1) + step_rest(out1))
    ticks_ok = (cf._same(out1[0].tick - TIME_SHIFT, out0[0].tick)
                and cf._same(out1[2][4] - TIME_SHIFT, out0[2][4]))
    if not (_same_all(*moved) and ticks_ok):
        add("time-cast",
            f"{label}.step: moving the tick counter by 2^24 changed "
            "outputs that are not times — an absolute tick cast to "
            "float32 (rebase to a difference before narrowing)")
    if rules.env and not found:
        bad = [tuple(t.shape) for t in c_flat
               if t.dim() < 1 or t.shape[0] != E]
        if bad:
            add("carry-env-mix",
                f"{label}.step: carry leaves {bad} are not (E, ...) on dim "
                "0: the env-sharded engine splits every carry leaf on its "
                "rows")
        else:
            widths = (cf.default_widths(E) if shard_widths is None
                      else tuple(shard_widths))
            perm = torch.from_numpy(rng.permutation(E))
            call = lambda r: step_rows(run(r))
            full = step_rows(out0)
            feat_others = [noise(t) for t in rows[:2]] + [None] * n_c + \
                [None] * len(masks) + [noise(t) for t in frame]
            carry_others = [None, None] + [noise(t) for t in c_flat] + \
                [None] * (len(masks) + len(frame))
            if cf.rows_exchange(call, rows, feat_others, full):
                add("env-reduce",
                    f"{label}.step: rows exchange values — changing some "
                    "rows' features changed the other rows' actions, "
                    "rewards or carry (a reduction or contraction over the "
                    "env axis)")
            elif n_c and cf.rows_exchange(call, rows, carry_others, full):
                add("carry-env-mix",
                    f"{label}.step: a row's step reads another row's "
                    "carry: changing some rows' carry changed the other "
                    "rows' outputs")
            else:
                _rows_family(call, rows, None, E, widths, perm, add,
                             "param-replication", f"{label}.step", full)
    _raise_if(found, f"{label}.step")

    # bank: a K-stack of transitions into a small ring of the same layout
    K, C = 3, 8
    ring = rp.init(E, C, F, A, device=dev)
    ring = ring._replace(**{k: noise(getattr(ring, k)) for k in
                            ("obs", "actions", "rewards", "next_obs")})
    ring.cursor.fill_(C - 2)
    trans = [_normal(rng, (K, E, F), dev), _normal(rng, (K, E, A), dev),
             _normal(rng, (K, E), dev), _normal(rng, (K, E, F), dev)]
    tick = torch.arange(5, 5 + K, dtype=torch.int32, device=dev)
    version = torch.zeros((K,), dtype=torch.int32, device=dev)
    have = torch.ones((K,), dtype=torch.bool, device=dev)
    env_mask = (torch.arange(K * E, device=dev).reshape(K, E) % 3 != 0
                if elastic else None)
    n_ring = 7

    def bank(rows, tick=tick):
        r = rp.ReplayBuffer(*(t.clone() for t in rows[:n_ring]),
                            cursor=ring.cursor.clone())
        tr_ = [t.transpose(0, 1) for t in rows[n_ring:n_ring + 4]]
        m = rows[n_ring + 4].transpose(0, 1) if elastic else None
        with torch.no_grad():
            out = decide.bank(r, (*tr_, tick, version, have),
                              env_mask=m) if elastic else \
                decide.bank(r, (*tr_, tick, version, have))
        return list(out[:n_ring])

    brows = list(ring[:n_ring]) + [t.transpose(0, 1) for t in trans] + (
        [env_mask.transpose(0, 1)] if elastic else [])
    a, b = bank(brows), bank(brows, tick + TIME_SHIFT)
    keep = [i for i in range(n_ring) if i != 4]     # all but tick_idx
    if not _same_all([a[i] for i in keep], [b[i] for i in keep]):
        add("time-cast",
            f"{label}.bank: moving the tick column by 2^24 changed "
            "ring leaves that are not times")
    if rules.env and not found:
        widths = (cf.default_widths(E) if shard_widths is None
                  else tuple(shard_widths))
        others = [noise(t) if t.is_floating_point() else None
                  for t in brows]
        _rows_family(bank, brows, others, E, widths,
                     torch.from_numpy(rng.permutation(E)), add,
                     "param-replication", f"{label}.bank")
    _raise_if(found, f"{label}.bank")


def check_train_step(fn: Callable, params, opt_state, replay, *,
                     batch: int = 8, label: str = "train_step") -> None:
    """Contract gate for the online policy-update step (run at
    ``OnlineTrainer(contract_check=True)`` construction).

    The loss MAY reduce over the sampled batch, so the env family is off.
    What must hold: no host read anywhere in the update (the step runs on
    the decide stream right after each batch; a host sync inside it
    re-serializes serving and training), and no float32 cast of absolute
    time: the step run with the ring's ``tick_idx`` moved by 2^24 must
    return the same bits.

    The step runs on a seeded probe ring of ``replay``'s layout (its
    shapes, dtypes, devices and shards), every cell valid and the ring
    full, never on ``replay`` itself: a trainer is built before its ring
    holds anything, and a step gates its result on valid rows, so an empty
    ring would hide any use of time. ``fn(params, opt_state, ring, es,
    ss)`` runs twice (it must be pure, as the trainer's is) on ``batch``
    indices drawn over the probe ring from a seeded generator."""
    from repro_torch.core import replay as rp
    found: list = []
    add = lambda rule, msg: found.append(Violation(rule, msg, label))
    rng = np.random.RandomState(0)

    def seeded(r):
        dev = r.obs.device
        return r._replace(
            obs=_normal(rng, tuple(r.obs.shape), dev),
            actions=_normal(rng, tuple(r.actions.shape), dev),
            rewards=_normal(rng, tuple(r.rewards.shape), dev),
            next_obs=_normal(rng, tuple(r.next_obs.shape), dev),
            tick_idx=torch.from_numpy(rng.randint(
                0, 4096, tuple(r.tick_idx.shape)).astype(np.int32)).to(dev),
            valid=torch.ones_like(r.valid),
            cursor=torch.full_like(r.cursor, r.capacity))

    one = isinstance(replay, rp.ReplayBuffer)
    probe = tuple(seeded(r) for r in rp.shard_rings(replay))
    moved = tuple(r._replace(tick_idx=r.tick_idx + TIME_SHIFT)
                  for r in probe)
    probe, moved = (probe[0], moved[0]) if one else (probe, moved)
    dev = rp.shard_rings(probe)[0].obs.device
    es, ss = rp.draw_device(
        probe, torch.Generator(device=dev).manual_seed(0), batch)
    out0 = _reads(lambda: fn(params, opt_state, probe, es, ss), dev, add,
                  label)
    out1 = fn(params, opt_state, moved, es, ss)
    if not _same_all(_leaves(out0), _leaves(out1)):
        add("time-cast",
            f"{label}: moving the replay's tick_idx by 2^24 changed the "
            "step's result — an absolute tick cast to float32 (rebase with "
            "a subtraction first)")
    _raise_if(found, label)


def check_system(predictor, decide=None, dstate=None, *, sharded: bool,
                 label: str = "PerceptaSystem", shard_widths=None) -> None:
    """Construction-time gate for ``PerceptaSystem`` (fused or sharded
    modes). The env family binds only under the env-sharded fused
    dispatch (``sharded``), at ``shard_widths`` (default: every proper
    divisor of E); the callback and time families hold for every build.
    Without ``decide`` (``scan_sharded``: the Predictor consumes on the
    host) the policy and the custom reward terms are checked at their true
    shapes. A clean result is cached by key."""
    rules = Rules(env=sharded)
    E, F = predictor.n_envs, predictor.n_features
    A = predictor.action_space.n
    widths = None if shard_widths is None else tuple(shard_widths)
    key = (predictor.model, predictor.reward_spec, E, F, A, rules, widths,
           decide is None, getattr(dstate, "active", None) is not None,
           str(predictor.device))
    try:
        if key in _CACHE:
            return
    except TypeError:          # an unhashable spec or model: no cache
        key = None
    if decide is not None:
        check_decide_fns(decide, dstate, E, F, rules=rules,
                         label=f"{label} fused decide",
                         shard_widths=widths)
    else:
        check_policy(predictor.model, F, n_envs=E, rules=rules,
                     device=predictor.device)
        check_reward_terms(predictor.reward_spec.terms, n_features=F,
                           n_actions=A, n_envs=E, rules=rules,
                           device=predictor.device)
    if key is not None:
        if len(_CACHE) >= _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = True


def clear_cache() -> None:
    """Drop every cached system check."""
    _CACHE.clear()


def check_builtins(verbose: bool = False) -> int:
    """Check every builtin policy, reward and decide path on the CPU, and
    certify every registered policy; returns the number of fns checked."""
    from repro_torch.core.reward import (KINDS, RewardSpec, RewardTerm,
                                         energy_reward_spec,
                                         validate_actions)
    from repro_torch.runtime.predictor import (ActionSpace, Predictor,
                                               linear_policy)

    E, F, A = 4, 6, 2
    n = 0
    check_policy(linear_policy(F, A, device="cpu"), F, n_envs=E)
    n += 1
    terms = [RewardTerm(k, feature=1, action=0, target=1.0, band=0.5)
             for k in KINDS if k != "custom"]
    terms.append(RewardTerm("custom", fn=lambda f, a, p:
                            -f[:, 1] * f[:, 0].clamp(min=0.0)))
    spec = RewardSpec(tuple(terms))
    check_reward_fn(lambda f, a, p: spec.compute(f, a, p)[0], E, F, A,
                    label="RewardSpec.compute[builtin kinds]")
    n += len(terms)
    espec = energy_reward_spec(price_idx=1, grid_idx=0, temp_idx=0)
    check_reward_fn(lambda f, a, p: espec.compute(f, a, p)[0], E, F, A,
                    label="energy_reward_spec.compute")
    n += 1
    lo, hi = -torch.ones((A,)), torch.ones((A,))
    rng = np.random.RandomState(0)
    _raise_if(check_fn(lambda a: validate_actions(a, lo, hi),
                       [_normal(rng, (E, A), torch.device("cpu")) * 2],
                       label="validate_actions"), "validate_actions")
    n += 1
    pred = Predictor(linear_policy(F, A, device="cpu"), espec,
                     ActionSpace(np.full(A, -1.0), np.full(A, 1.0)), E, F,
                     replay_capacity=16, device="cpu")
    check_decide_fns(pred.make_decide_fn(), pred.decide_state(), E, F,
                     label="builtin DecideFns")
    n += 2
    el = pred.decide_state()._replace(active=torch.arange(E) < 2,
                                      prev_ok=torch.zeros((E,), dtype=bool))
    check_decide_fns(pred.make_decide_fn(), el, E, F,
                     label="builtin elastic DecideFns")
    n += 1
    from repro_torch.runtime.policies import POLICIES
    for key, builder in POLICIES.items():
        cf.certify_policy(builder, name=key, cache_key=("builtin", key))
        n += 1
    if verbose:
        print(f"contract check: {n} builtin fns clean")
    return n
