"""The port's contract violations, named by the reference's rule ids.

``repro.analysis.contracts`` declares every rule of the reference's jaxpr
checker and lint. The port checks its rules by behaviour
(``analysis.certify``, ``analysis.check``) and with an AST lint over
torch code (``analysis.lint``), so it keeps the ids of those rules only,
with what a probe or the lint observes when each is broken. ``RULES`` are
the probes', ``LINT_RULES`` the lint's.
"""
from __future__ import annotations

from dataclasses import dataclass

RULES = {
    "env-reduce":
        "a row's actions or carry change when ANOTHER row's features "
        "change: a reduction or contraction over the env axis "
        "(env-reduce, env-contraction); under the env-sharded engine each "
        "shard would see only its own rows",
    "env-gemm-rows":
        "a row's bits change with the NUMBER of rows in the call, its "
        "neighbours' values unchanged: rounding that depends on the row "
        "count (a library gemm picks its kernel by M); phrase per-env dots "
        "as multiply + sum over features (runtime.policies._rowdot)",
    "carry-env-mix":
        "a recurrent carry must keep env row i's state in row i: every "
        "carry leaf is (E, ...) on dim 0, a row's step reads no other "
        "row's carry, and two steps on a permuted carry equal the "
        "permuted two steps",
    "param-replication":
        "policy params are replicated on the env mesh "
        "(sharding.decide_specs): no param leaf may be sized by E, and the "
        "policy must run at a shard's row count",
    "reward-shape":
        "custom reward fns return one reward per env row: (E,) for (E, F) "
        "features, at every env count the fn is called with",
    "callback-in-scan":
        "no host read inside the decide step or the train step (Tensor.cpu, "
        ".item, .tolist, .numpy, bool/int/float of a tensor) — it hides a "
        "host sync in the per-window hot loop and cannot be captured in a "
        "CUDA graph",
    "time-cast":
        "no float32 (or narrower) cast of an absolute time: moving the time "
        "inputs (the int32 tick counter, the replay's tick_idx) by 2^24 must "
        "leave every other output's bits unchanged — float32 absolute "
        "ticks quantize past 2^24; rebase (subtract a time) before "
        "narrowing",
}

LINT_RULES = {
    "state-leaf-alias":
        "host code never aliases system.state leaves (system.state.norm "
        "etc.) outside runtime/system.py — the sharded modes hold a tuple "
        "of per-shard trees there and the engines replace the tree each "
        "batch; use the snapshot accessors (snapshot_state / snapshot_norm "
        "/ export_replay)",
    "lock-multi-acquire":
        "runtime/ locks are one-acquire-per-call: no with-lock inside a "
        "loop, no nested acquire of the same lock, no call to a sibling "
        "method that re-acquires the held lock (batch first, lock once)",
}


@dataclass(frozen=True)
class Violation:
    """One finding: the rule id and what the probe saw."""
    rule: str
    message: str
    label: str = ""
    source: str = ""

    def format(self) -> str:
        return f"[{self.rule}]: {self.message}"


class ContractViolation(ValueError):
    """A checked policy breaks a rule; the message names every rule id."""

    def __init__(self, violations, label: str = ""):
        self.violations = list(violations)
        head = (f"{len(self.violations)} contract violation(s)"
                f"{' in ' + label if label else ''} (rule ids as in the "
                "reference's repro.analysis.contracts):")
        lines = [head] + ["  " + v.format() for v in self.violations]
        super().__init__("\n".join(lines))
