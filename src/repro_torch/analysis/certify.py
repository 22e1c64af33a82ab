"""Policy certification by behaviour — the port's counterpart of
``repro.analysis.certify.certify_policy`` for the env-axis rules.

The reference traces a policy to a jaxpr and follows env provenance
through it. PyTorch has no such program to read, so the port runs the
policy step on seeded probes and asserts what the env-sharded fused
engine relies on: a row's actions and carry are a function of that row's
own features and carry, computed the same whatever rows sit beside it.
Three families, each named by the reference's rule id
(``analysis.contracts``):

  * **rows** (``env-reduce`` / ``env-gemm-rows``): at the true (E, F, A),
    replacing the features of one half of the rows leaves the other
    half's bits unchanged (else ``env-reduce``: the rows exchange
    values); each block of every shard width E/N gives the rows the bits
    of the full call (else ``env-gemm-rows``: rounding depends on the row
    count); permuted rows give the permuted outputs (else ``env-reduce``:
    a row's output depends on its position);
  * **carry** (``carry-env-mix``): every carry leaf is (E, ...) on dim 0
    at two env counts; replacing one half's carry leaves the other half's
    step unchanged; two steps on a permuted carry equal the permuted two
    steps;
  * **params** (``param-replication``): the builder gives the same param
    paths and shapes at two env counts, and the step runs at a shard's
    row count (an E-sized weight, in params or in a closure, fails
    there), since ``sharding.decide_specs`` replicates the params.

A probe can only see what its inputs exercise; it is no proof. The rows
probes (:func:`rows_exchange`, :func:`rows_split`, :func:`rows_permute`)
serve ``analysis.check`` too, over custom reward fns and the whole decide
step; the time and callback rules live there, the host-code rules in
``analysis.lint``. A :class:`PolicyCertificate` records what was checked,
and certificates are cached by key, so a repeated build skips the probes.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import ContractViolation, Violation

# (E, F, A) probe shapes of a registry build (the reference's default E)
DEFAULT_PROBES: Tuple[Tuple[int, int, int], ...] = ((4, 6, 2),)


class Rules(NamedTuple):
    """Which families bind: ``env`` the rows family, ``carry`` the
    recurrent-carry family. ``param-replication`` is probed whenever a
    builder is given (a prebuilt adapter has no env count to vary)."""
    env: bool = True
    carry: bool = True


CERTIFY_RULES = Rules()
_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class PolicyCertificate:
    """What a policy passed: the rule ids probed, the probe shapes and
    shard widths, the carry's leaf shapes at the probe E (empty for a
    stateless policy) and every param leaf as ``(path, shape, dtype)``."""
    name: str
    rules: Tuple[str, ...]
    probe_shapes: Tuple[Tuple[int, int, int], ...]
    shard_widths: Tuple[int, ...]
    carry_structure: str
    param_spec: Tuple[Tuple[str, Tuple[int, ...], str], ...]
    stateful: bool

    def describe(self) -> str:
        kind = "stateful" if self.stateful else "stateless"
        return (f"PolicyCertificate({self.name}: {kind}, "
                f"{len(self.param_spec)} param leaves, "
                f"rules={','.join(self.rules)}, "
                f"widths={list(self.shard_widths)})")


def _describe_builder(builder, name: Optional[str]) -> str:
    base = builder
    while isinstance(base, functools.partial):
        base = base.func
    if not callable(base) or hasattr(base, "fn"):
        built = f"adapter {getattr(base, 'name', type(base).__name__)}"
    else:
        qual = getattr(base, "__qualname__", type(base).__name__)
        built = f"builder {getattr(base, '__module__', '')}.{qual}"
    return f"policy '{name}' ({built})" if name else f"policy {built}"


def _is_builder(builder) -> bool:
    return callable(builder) and not hasattr(builder, "fn")


def _build(builder, F: int, A: int, E: int, device):
    if not _is_builder(builder):
        return builder                      # a prebuilt ModelAdapter
    try:
        params = inspect.signature(builder).parameters.values()
        kw_ok = lambda k: any(p.kind == p.VAR_KEYWORD or p.name == k
                              for p in params)
    except (TypeError, ValueError):
        kw_ok = lambda k: True
    kw = {k: v for k, v in (("n_envs", E), ("device", device)) if kw_ok(k)}
    return builder(F, A, **kw)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}['{k}']")
        return out
    return [(prefix, tree)]


def _same(a, b) -> bool:
    """Bit equality of two tensors (NaNs of equal bits are equal)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a = a.contiguous().view(ints[a.element_size()])
        b = b.contiguous().view(ints[b.element_size()])
    return bool(torch.equal(a.cpu(), b.cpu()))


def _sel(t, rows):
    return t[rows.to(t.device)]


def _flat(out):
    actions, carry = out
    from repro_torch.train import tree as tr
    return [actions] + tr.leaves(carry)


def _rows(tree, idx):
    from repro_torch.train import tree as tr
    return None if tree is None else tr.map_(lambda x: x[idx], tree)


# --- the rows probes, over any call whose inputs and outputs are (E, ...) ---
# ``call(rows) -> outputs``: ``rows`` and ``outputs`` are lists of tensors
# indexed by env row on dim 0; whatever else the call reads it closes over.
# The policy certificate below and ``analysis.check`` (reward fns, the
# decide step and its bank) run the same three probes.

def _halves(E: int):
    return (torch.arange(E) < E // 2, torch.arange(E) >= E // 2) \
        if E > 1 else ()


def rows_exchange(call, rows, others, full=None) -> bool:
    """True when the rows exchange values: for either half of the E rows,
    putting ``others[i]``'s rows in place of ``rows[i]``'s (where
    ``others[i]`` is not None) changes the OTHER half's outputs."""
    full = call(rows) if full is None else full
    E = rows[0].shape[0]

    def swap(t, o, half):
        if o is None:
            return t
        m = half.to(t.device).reshape((E,) + (1,) * (t.dim() - 1))
        return torch.where(m, o, t)

    for half in _halves(E):
        got = call([swap(t, o, half) for t, o in zip(rows, others)])
        if not all(_same(_sel(a, ~half), _sel(b, ~half))
                   for a, b in zip(full, got)):
            return True
    return False


def rows_split(call, rows, widths, full):
    """Each block of ``w`` rows, for every ``w`` in ``widths`` (proper
    divisors of E), called alone must give the full call's rows. Returns
    None, or ``(kind, w, block, detail)``: kind ``"sized"`` when the call
    fails or returns other shapes at w rows (something in it is sized by
    E), ``"rounding"`` when the rows get other bits (env-gemm-rows)."""
    E = rows[0].shape[0]
    for w in widths:
        if w < 1 or E % w or w == E:
            continue
        for b in range(E // w):
            sl = slice(b * w, (b + 1) * w)
            try:
                part = call([t[sl] for t in rows])
            except (RuntimeError, ValueError, IndexError) as e:
                return ("sized", w, b, f"{type(e).__name__}: "
                        f"{str(e).splitlines()[0][:120]}")
            if any(a[sl].shape != p.shape for a, p in zip(full, part)):
                return ("sized", w, b, "other shapes")
            if not all(_same(a[sl], p) for a, p in zip(full, part)):
                return ("rounding", w, b, "")
    return None


def rows_permute(call, rows, perm, full) -> bool:
    """True when permuted input rows give the permuted output rows."""
    got = call([t[perm.to(t.device)] for t in rows])
    return all(_same(a[perm.to(a.device)], g) for a, g in zip(full, got))


def default_widths(E: int) -> Tuple[int, ...]:
    """Every proper divisor of E: the row counts a shard may hold."""
    return tuple(w for w in range(1, E) if E % w == 0)


def certify_policy(builder, probe_shapes: Sequence = DEFAULT_PROBES, *,
                   name: Optional[str] = None, rules: Rules = CERTIFY_RULES,
                   shard_widths: Optional[Sequence[int]] = None,
                   device="cpu", cache_key: Any = None) -> PolicyCertificate:
    """Probe a policy builder (``builder(F, A, n_envs=E, device=...)``,
    the registry convention) or a prebuilt ``ModelAdapter`` and return a
    :class:`PolicyCertificate`, or raise
    :class:`~repro_torch.analysis.contracts.ContractViolation` naming the
    rule ids. ``probe_shapes``: ``(E, F, A)`` triples; ``shard_widths``:
    the row counts a shard may hold (default: every proper divisor of each
    probe's E); inputs come from ``numpy.random.RandomState(0)`` on
    ``device``."""
    if cache_key is not None and cache_key in _CACHE:
        return _CACHE[cache_key]
    from repro_torch.runtime.predictor import policy_call2
    from repro_torch.train import tree as tr

    probes = tuple((int(e), int(f), int(a)) for e, f, a in probe_shapes)
    label = _describe_builder(builder, name)
    device = torch.device(device)
    found: list = []
    checked = set()
    widths_seen: set = set()
    carry_structure, param_spec, stateful = "", (), False

    def add(rule, msg):
        found.append(Violation(rule, msg, label))

    for E, F, A in probes:
        adapter = _build(builder, F, A, E, device)
        apply2, params, init_carry = policy_call2(adapter)
        stateful = stateful or init_carry is not None
        param_spec = tuple((p, tuple(x.shape), str(x.dtype).replace(
            "torch.", "")) for p, x in _paths(params))
        if _is_builder(builder):
            checked.add("param-replication")
            other = _build(builder, F, A, E + 1, device)
            params2 = policy_call2(other)[1]
            pa, pb = _paths(params), _paths(params2)
            if [k for k, _ in pa] != [k for k, _ in pb]:
                add("param-replication",
                    f"the param tree changes between E={E} and E={E + 1} "
                    "builds: params must not depend on the env count "
                    "(replicated on the mesh, sharding.decide_specs)")
            else:
                for (path, a), (_, b) in zip(pa, pb):
                    if tuple(a.shape) != tuple(b.shape):
                        add("param-replication",
                            f"param leaf '{path}' is env-sized: shape "
                            f"{tuple(a.shape)} at E={E}, {tuple(b.shape)} "
                            f"at E={E + 1}; per-env weights cannot ride "
                            "the replicated policy subtree "
                            "(sharding.decide_specs); keep per-env state "
                            "in the carry")
                        break
            if found:
                continue
        rng = np.random.RandomState(0)
        feats = lambda: torch.from_numpy(
            rng.normal(0.0, 1.0, (E, F)).astype(np.float32)).to(device)
        x, x_other, x2 = feats(), feats(), feats()

        def step(f, c):
            with torch.no_grad():
                return apply2(params, f, c)

        c0 = None
        if init_carry is not None:
            carry_e = init_carry(E)
            carry_structure = str(tr.map_(lambda t: tuple(t.shape), carry_e))
            if rules.carry:
                checked.add("carry-env-mix")
                more = init_carry(E + 1)
                bad = [tuple(a.shape) for a, b in zip(tr.leaves(carry_e),
                                                      tr.leaves(more))
                       if a.dim() < 1 or a.shape[0] != E
                       or b.shape[0] != E + 1]
                if bad:
                    add("carry-env-mix",
                        f"carry leaves {bad} are not (E, ...) on dim 0 at "
                        f"E={E} and E={E + 1}: the env-sharded engine "
                        "splits every carry leaf on its rows")
                    continue

            def noise(t):
                if not t.is_floating_point():
                    return t
                r = rng.normal(0.0, 0.5, tuple(t.shape)).astype(np.float32)
                return torch.from_numpy(r).to(t.device, t.dtype)

            c0 = tr.map_(noise, carry_e)
            c_other = tr.map_(noise, carry_e)
        c_flat, c_def = tr.flatten(c0)

        def call(rows):
            return _flat(step(rows[0], tr.unflatten(c_def, rows[1:])))

        rows = [x] + c_flat
        full = call(rows)
        if rules.env:
            checked.update(("env-reduce", "env-gemm-rows"))
            # row independence: change one half's features, read the other
            if rows_exchange(call, rows, [x_other] + [None] * len(c_flat),
                             full):
                add("env-reduce",
                    "rows exchange values: changing some rows' features "
                    "changed the other rows' actions or carry (a reduction "
                    "or contraction over the env axis)")
                continue
        if rules.carry and c0 is not None and rows_exchange(
                call, rows, [None] + tr.leaves(c_other), full):
            add("carry-env-mix",
                "a row's step reads another row's carry: changing some "
                "rows' carry changed the other rows' actions or carry")
            continue
        if rules.env:
            widths = (tuple(shard_widths) if shard_widths is not None
                      else default_widths(E))
            bad = rows_split(call, rows, widths, full)
            if bad is not None:
                kind, w, blk, detail = bad
                if kind == "rounding":
                    add("env-gemm-rows",
                        f"rows {blk * w}..{(blk + 1) * w - 1} get other "
                        f"bits in a call of {w} rows than in one of "
                        f"{E}: rounding depends on the row count")
                elif detail == "other shapes":
                    add("param-replication",
                        f"a call of {w} rows of E={E} returns other "
                        "shapes than the rows of the full call: "
                        "something in the policy is sized by E, and "
                        "sharding.decide_specs replicates params whole")
                else:
                    add("param-replication",
                        f"the step fails at a shard's {w} rows of "
                        f"E={E} ({detail}): something "
                        "in the policy is sized by E, and "
                        "sharding.decide_specs replicates params whole")
                continue
            widths_seen.update(int(w) for w in widths
                               if 1 <= w < E and E % w == 0)
            perm = torch.from_numpy(rng.permutation(E))
            if not rows_permute(call, rows, perm, full):
                add("env-reduce",
                    "permuted rows do not give the permuted outputs: a "
                    "row's result depends on its position among the rows")
                continue
        if rules.carry and c0 is not None:
            p = perm if rules.env else torch.from_numpy(rng.permutation(E))
            a1 = step(x, c0)
            two = _flat(step(x2, a1[1]))
            pd = p.to(device)
            b1 = step(x[pd], _rows(c0, pd))
            two_p = _flat(step(x2[pd], b1[1]))
            if not all(_same(a[p.to(a.device)], b)
                       for a, b in zip(two, two_p)):
                add("carry-env-mix",
                    "two steps on a permuted carry differ from the permuted "
                    "two steps: the carry moves state between rows")
                continue

    if found:
        raise ContractViolation(found, label)
    cert = PolicyCertificate(
        name=name or label, rules=tuple(sorted(checked)),
        probe_shapes=probes, shard_widths=tuple(sorted(widths_seen)),
        carry_structure=carry_structure, param_spec=param_spec,
        stateful=stateful)
    if cache_key is not None:
        _CACHE[cache_key] = cert
    return cert


def clear_cache() -> None:
    """Drop every cached certificate."""
    _CACHE.clear()
