"""The port's contract violations, named by the reference's rule ids.

``repro.analysis.contracts`` declares every rule of the reference's jaxpr
checker and lint. The port checks the env-axis rules by behaviour
(``analysis.certify``), so it keeps the ids of those rules only, with what
a probe observes when each is broken.
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
}


@dataclass(frozen=True)
class Violation:
    """One finding: the rule id and what the probe saw."""
    rule: str
    message: str
    label: str = ""

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
