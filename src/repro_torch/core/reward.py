"""Reward computation — port of ``repro.core.reward``.

Rewards are declared as a list of :class:`RewardTerm` (weighted references
to feature/action indices with a shape function) evaluated over all
environments per tick. ``custom`` takes any function of torch tensors.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

import torch

KINDS = ("linear", "abs_error", "quadratic_error", "band_penalty",
         "threshold_bonus", "action_smoothness", "custom")


@dataclass(frozen=True)
class RewardTerm:
    kind: str
    weight: float = 1.0
    feature: int = 0              # feature index the term reads
    action: Optional[int] = None  # action index (action-dependent terms)
    target: float = 0.0           # setpoint / threshold
    band: float = 0.0             # tolerance band half-width
    fn: Optional[Callable] = None # custom: fn(features, actions, prev)->(E,)

    def evaluate(self, features, actions, prev_actions):
        """Evaluate on (..., E, F)/(..., E, A). Built-in terms index the
        last axis and are elementwise, so a K-leading stack of windows
        evaluates in one call, bit-identical to K per-window calls.
        ``custom`` fns keep their (E, F) contract and run once per window
        over any leading axes."""
        f = features[..., self.feature]
        if self.kind == "linear":
            return self.weight * f
        if self.kind == "abs_error":
            return -self.weight * (f - self.target).abs()
        if self.kind == "quadratic_error":
            d = f - self.target
            return -self.weight * (d * d)
        if self.kind == "band_penalty":
            over = ((f - self.target).abs() - self.band).clamp(min=0.0)
            return -self.weight * over
        if self.kind == "threshold_bonus":
            return self.weight * (f > self.target).to(torch.float32)
        if self.kind == "action_smoothness":
            d = actions[..., self.action] - prev_actions[..., self.action]
            return -self.weight * (d * d)
        if self.kind == "custom":
            def apply(f, a, p):
                if f.dim() == 2:
                    return self.fn(f, a, p)
                return torch.stack([apply(*xs) for xs in zip(f, a, p)])
            return self.weight * apply(features, actions, prev_actions)
        raise ValueError(self.kind)


@dataclass(frozen=True)
class RewardSpec:
    """A reward program: weighted terms summed per env per tick. The total
    is a left fold of adds over the term stack, in term order.

    Custom terms are checked at construction against the per-env row-wise
    contract (``analysis.check.check_reward_terms``: one reward per row,
    no reduction over the env axis, no rounding that moves with the row
    count, no host read). ``unchecked=True`` skips the check (logged) for
    fns the probe cannot run at spec time; they are still checked at true
    shapes when a fused or sharded ``PerceptaSystem`` is built.
    """
    terms: tuple
    unchecked: bool = False

    def __post_init__(self):
        if self.unchecked:
            logging.getLogger(__name__).info(
                "RewardSpec(unchecked=True): skipping the contract check "
                "on %d term(s); custom fns will still be checked at "
                "system construction for sharded/fused modes",
                len(self.terms))
            return
        if any(t.kind == "custom" for t in self.terms):
            # lazy import: the checks import the runtime, which imports
            # this module
            from repro_torch.analysis.check import check_reward_terms
            check_reward_terms(self.terms)

    def compute(self, features, actions, prev_actions=None):
        """features (..., E, F), actions (..., E, A) ->
        (total (..., E), per_term (..., E, n_terms))."""
        if prev_actions is None:
            prev_actions = torch.zeros_like(actions)
        per = torch.stack([t.evaluate(features, actions, prev_actions)
                           for t in self.terms], dim=-1)
        total = per[..., 0]
        for i in range(1, len(self.terms)):
            total = total + per[..., i]
        return total, per


def energy_reward_spec(price_idx: int, grid_idx: int, temp_idx: int,
                       comfort_target: float = 21.0,
                       comfort_band: float = 1.5,
                       hvac_action: int = 0) -> RewardSpec:
    """The OPEVA building-energy reward: cost + comfort + smoothness."""
    return RewardSpec(terms=(
        RewardTerm("custom", weight=1.0, fn=lambda f, a, p:
                   -f[:, price_idx] * f[:, grid_idx].clamp(min=0.0)),
        RewardTerm("band_penalty", weight=2.0, feature=temp_idx,
                   target=comfort_target, band=comfort_band),
        RewardTerm("action_smoothness", weight=0.1, action=hvac_action),
    ))


def validate_actions(actions, low, high):
    """Clamp into the actuator envelope and flag violations. Returns
    (clamped, violated (E,))."""
    clamped = torch.clamp(actions, low, high)
    violated = ((actions < low) | (actions > high)).any(-1)
    return clamped, violated
