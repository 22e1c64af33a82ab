"""Policy registry — port of ``repro.runtime.policies`` for the policies of
this slice (``linear``, ``rglru``).

A frozen :class:`PolicyConfig` (name + kwargs) dispatches through a dict of
builders. Every builder takes ``params=`` to load given weights (the
reference's, through ``convert.policy_params_from_numpy``); without it the
weights come from ``torch.Generator().manual_seed(seed)``, which draws
different numbers from the reference's JAX generator at the same seed.
Every dot is multiply + sum over the contracted dim (``_rowdot``), so its
rounding depends only on that dim, never on the number of env rows.
Certification of a policy waits for the contract-check slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.runtime.predictor import ModelAdapter, linear_policy

NOT_PORTED = ("mlp", "rwkv6")


def _rowdot(x, w):
    """``x (..., F) @ w (F, H)`` as multiply + sum over F, so the add order
    depends only on F and never on the row count."""
    return (x[..., :, None] * w).sum(-2)


def _scale(logits, low, high):
    return torch.tanh(logits) * (high - low) / 2 + (high + low) / 2


def linear_builder(n_features: int, n_actions: int, n_envs: int = None,
                   seed: int = 0, low=-1.0, high=1.0, *, params=None,
                   device="cpu") -> ModelAdapter:
    """The deployed linear policy (``runtime.predictor.linear_policy``)."""
    del n_envs  # stateless and env-count independent
    return linear_policy(n_features, n_actions, seed=seed, low=low,
                         high=high, params=params, device=device)


class RGLRUPolicy(nn.Module):
    """Recurrent RG-LRU policy: the single-step, env-rows-as-batch form of
    the RG-LRU gate math. Parameter names are the reference's param keys.

    The state update h' = a*h + b runs through the ``kernels/rglru_scan``
    op at B = E, T = 1 when ``use_kernel`` (its plain version otherwise).
    Carry: ``{"h": (E, hidden)}``.
    """

    def __init__(self, n_features: int, n_actions: int, hidden: int = 16,
                 seed: int = 0, low=-1.0, high=1.0,
                 use_kernel: bool = False):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        randn = lambda *shape: torch.randn(shape, generator=g)
        init = {
            "w_in": randn(n_features, hidden) / n_features ** 0.5,
            "w_a": randn(hidden) * 0.1,
            "b_a": torch.zeros(hidden),
            "w_i": randn(hidden) * 0.1,
            "b_i": torch.zeros(hidden),
            # softplus(lam): forget rates spread across the units
            "lam": torch.linspace(-2.0, 1.0, hidden),
            "w_out": randn(hidden, n_actions) / hidden ** 0.5,
        }
        for name, t in init.items():
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))
        self.hidden = hidden
        self.low, self.high = low, high
        self.use_kernel = use_kernel

    def init_carry(self, n_envs: int):
        return {"h": torch.zeros((n_envs, self.hidden), dtype=torch.float32,
                                 device=self.w_in.device)}

    def forward(self, feats, carry):
        h = carry["h"]                                   # (E, H)
        u = _rowdot(feats, self.w_in)                    # (E, H)
        r = torch.sigmoid(u * self.w_a[None] + self.b_a[None])
        i = torch.sigmoid(u * self.w_i[None] + self.b_i[None])
        log_a = -8.0 * nn.functional.softplus(self.lam)[None] * r
        gated = i * u
        b = (1.0 - torch.exp(2.0 * log_a)).clamp(min=1e-12).sqrt() * gated
        a3, b3 = torch.exp(log_a)[:, None, :], b[:, None, :]
        if self.use_kernel:
            from repro_torch.kernels.rglru_scan.ops import rglru_scan
            _, h_new = rglru_scan(a3, b3, h)
        else:
            from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
            _, h_new = rglru_scan_ref(a3, b3, h)
        actions = _scale(_rowdot(h_new, self.w_out), self.low, self.high)
        return actions, {"h": h_new}


def rglru_builder(n_features: int, n_actions: int, n_envs: int = None,
                  hidden: int = 16, seed: int = 0, low=-1.0, high=1.0,
                  use_kernel: bool = False, *, params=None,
                  device="cpu") -> ModelAdapter:
    """The recurrent RG-LRU policy as an :class:`RGLRUPolicy` module."""
    del n_envs  # the carry is built by init_carry at the system's env count
    module = RGLRUPolicy(n_features, n_actions, hidden=hidden, seed=seed,
                         low=low, high=high, use_kernel=use_kernel)
    if params is not None:
        module.load_state_dict({k: torch.as_tensor(v)
                                for k, v in params.items()})
    module = module.to(device)
    return ModelAdapter(
        None, "rglru_policy", params=dict(module.named_parameters()),
        apply_carry=lambda p, feats, carry: module(feats, carry),
        init_carry=module.init_carry, module=module)


POLICIES = {
    "linear": linear_builder,
    "rglru": rglru_builder,
}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Registry spec: a policy name plus builder kwargs, e.g.
    ``PolicyConfig("rglru", {"hidden": 16, "use_kernel": True})``."""
    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def build_policy(spec, n_features: int, n_actions: int, n_envs: int, *,
                 device=None, **overrides) -> ModelAdapter:
    """Resolve a registry name / :class:`PolicyConfig` to a
    :class:`~repro_torch.runtime.predictor.ModelAdapter` on ``device``
    (``None`` means the CUDA card)."""
    if isinstance(spec, str):
        spec = PolicyConfig(spec)
    if spec.name in NOT_PORTED:
        raise ValueError(f"policy {spec.name!r} is not ported yet "
                         f"(ported: {sorted(POLICIES)}); see ROADMAP.md")
    try:
        builder = POLICIES[spec.name]
    except KeyError:
        raise KeyError(
            f"Unrecognized policy provided: {spec.name!r} "
            f"(registered: {sorted(POLICIES)})") from None
    kwargs = dict(spec.kwargs)
    kwargs.update(overrides)
    return functools.partial(builder, **kwargs)(
        n_features, n_actions, n_envs=n_envs, device=resolve_device(device))
