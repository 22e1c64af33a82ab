"""Policy registry — port of ``repro.runtime.policies``: ``linear``,
``mlp``, ``rglru`` and ``rwkv6``.

A frozen :class:`PolicyConfig` (name + kwargs) dispatches through a dict of
builders. Every builder takes ``params=`` to load given weights (the
reference's, through ``convert.policy_params_from_numpy``); without it the
weights come from ``torch.Generator().manual_seed(seed)``, which draws
different numbers from the reference's JAX generator at the same seed.
Every dot is multiply + sum over the contracted dim (``_rowdot``), so its
rounding depends only on that dim, never on the number of env rows; every
transcendental function of per-env values goes through
``predictor.rowwise``, whose rounding does not depend on it either.
``linear`` and ``mlp`` are stateless (``apply(params, feats)``), so the
online trainer can train them; ``rglru`` and ``rwkv6`` keep per-env
recurrent state in their carry leaves (row i's state in row i).
:func:`build_policy` certifies the builder (``analysis.certify``: rows,
carry and param-replication probes at E = 4 with the real feature and
action counts) and attaches the certificate as ``adapter.certificate``,
cached by ``(name, kwargs, probes, device type)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.runtime.predictor import (ModelAdapter, linear_policy,
                                           rowwise)

def _rowdot(x, w):
    """``x (..., F) @ w (F, H)`` as multiply + sum over F, so the add order
    depends only on F and never on the row count."""
    return (x[..., :, None] * w).sum(-2)


def _scale(logits, low, high):
    return rowwise(torch.tanh, logits) * (high - low) / 2 + (high + low) / 2


def linear_builder(n_features: int, n_actions: int, n_envs: int = None,
                   seed: int = 0, low=-1.0, high=1.0, *, params=None,
                   device=None) -> ModelAdapter:
    """The deployed linear policy (``runtime.predictor.linear_policy``)."""
    del n_envs  # stateless and env-count independent
    return linear_policy(n_features, n_actions, seed=seed, low=low,
                         high=high, params=params, device=device)


def mlp_builder(n_features: int, n_actions: int, n_envs: int = None,
                hidden: int = 32, seed: int = 0, low=-1.0, high=1.0, *,
                params=None, device=None) -> ModelAdapter:
    """Two-layer gated MLP (SwiGLU), stateless and row-wise."""
    del n_envs  # stateless and env-count independent
    device = resolve_device(device)
    if params is None:
        g = torch.Generator().manual_seed(seed)
        randn = lambda *shape: torch.randn(shape, generator=g)
        params = {
            "w1": randn(n_features, hidden) / n_features ** 0.5,
            "w3": randn(n_features, hidden) / n_features ** 0.5,
            "w2": randn(hidden, n_actions) / hidden ** 0.5,
        }
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}

    def apply(params, feats):
        h = _rowdot(feats, params["w1"])
        g = _rowdot(feats, params["w3"])
        return _scale(_rowdot(rowwise(nn.functional.silu, g) * h,
                              params["w2"]), low, high)

    return ModelAdapter(lambda feats: apply(params, feats), "mlp_policy",
                        params=params, apply=apply)


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
        return self.step(dict(self.named_parameters()), feats, carry)

    def step(self, p, feats, carry):
        """One step with the params ``p`` (the module's own, or copies of
        them on another device: a shard's replicated policy)."""
        h = carry["h"]                                   # (E, H)
        u = _rowdot(feats, p["w_in"])                    # (E, H)
        r = rowwise(torch.sigmoid, u * p["w_a"][None] + p["b_a"][None])
        i = rowwise(torch.sigmoid, u * p["w_i"][None] + p["b_i"][None])
        log_a = -8.0 * nn.functional.softplus(p["lam"])[None] * r
        gated = i * u
        b = (1.0 - rowwise(torch.exp, 2.0 * log_a)).clamp(min=1e-12) \
            .sqrt() * gated
        a3, b3 = rowwise(torch.exp, log_a)[:, None, :], b[:, None, :]
        if self.use_kernel:
            from repro_torch.kernels.rglru_scan.ops import rglru_scan
            _, h_new = rglru_scan(a3, b3, h)
        else:
            from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
            _, h_new = rglru_scan_ref(a3, b3, h)
        actions = _scale(_rowdot(h_new, p["w_out"]), self.low, self.high)
        return actions, {"h": h_new}


def rglru_builder(n_features: int, n_actions: int, n_envs: int = None,
                  hidden: int = 16, seed: int = 0, low=-1.0, high=1.0,
                  use_kernel: bool = False, *, params=None,
                  device=None) -> ModelAdapter:
    """The recurrent RG-LRU policy as an :class:`RGLRUPolicy` module."""
    del n_envs  # the carry is built by init_carry at the system's env count
    device = resolve_device(device)
    module = RGLRUPolicy(n_features, n_actions, hidden=hidden, seed=seed,
                         low=low, high=high, use_kernel=use_kernel)
    if params is not None:
        module.load_state_dict({k: torch.as_tensor(v)
                                for k, v in params.items()})
    module = module.to(device)
    return ModelAdapter(
        None, "rglru_policy", params=dict(module.named_parameters()),
        apply_carry=module.step,
        init_carry=module.init_carry, module=module)


def rwkv6_builder(n_features: int, n_actions: int, n_envs: int = None,
                  hidden: int = 8, seed: int = 0, low=-1.0, high=1.0, *,
                  params=None, device=None) -> ModelAdapter:
    """Recurrent RWKV-6 policy: the single-head, single-step form of the
    RWKV-6 time mix (token shift, data-dependent decay, wkv state), env
    rows as the batch, its attention einsum as multiply + sum.

    Carry: ``{"shift": (E, F), "wkv": (E, hidden, hidden)}``.
    """
    del n_envs  # the carry is built by init_carry at the system's env count
    device = resolve_device(device)
    D = hidden
    if params is None:
        g = torch.Generator().manual_seed(seed)
        randn = lambda *shape: torch.randn(shape, generator=g)
        params = {
            "mu": torch.rand((4, n_features), generator=g),  # r/k/v/w mixes
            "w_r": randn(n_features, D) / n_features ** 0.5,
            "w_k": randn(n_features, D) / n_features ** 0.5,
            "w_v": randn(n_features, D) / n_features ** 0.5,
            "w_decay": randn(n_features, D) / n_features ** 0.5,
            "decay_base": torch.zeros(D),
            "bonus": torch.zeros(D),
            "w_o": randn(D, n_actions) / D ** 0.5,
        }
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}

    def apply_carry(params, feats, carry):
        shift, S = carry["shift"], carry["wkv"]          # (E,F), (E,D,D)
        mixed = feats[None] + params["mu"][:, None, :] * (shift - feats)[None]
        r = _rowdot(mixed[0], params["w_r"])             # (E, D)
        k = _rowdot(mixed[1], params["w_k"])
        v = _rowdot(mixed[2], params["w_v"])
        lw = _rowdot(mixed[3], params["w_decay"]) \
            + params["decay_base"][None]
        log_w = torch.clamp(-rowwise(torch.exp, torch.clamp(lw, -8.0, 3.0)),
                            -20.0, -1e-5)
        kv = k[..., :, None] * v[..., None, :]           # (E, D, D)
        att = S + params["bonus"][None, :, None] * kv
        out = (r[..., :, None] * att).sum(-2)            # einsum('ek,ekv->ev')
        S_new = rowwise(torch.exp, log_w)[..., :, None] * S + kv
        actions = _scale(_rowdot(out, params["w_o"]), low, high)
        return actions, {"shift": feats, "wkv": S_new}

    def init_carry(n_envs):
        f32 = dict(dtype=torch.float32, device=device)
        return {"shift": torch.zeros((n_envs, n_features), **f32),
                "wkv": torch.zeros((n_envs, D, D), **f32)}

    return ModelAdapter(None, "rwkv6_policy", params=params,
                        apply_carry=apply_carry, init_carry=init_carry)


POLICIES = {
    "linear": linear_builder,
    "mlp": mlp_builder,
    "rglru": rglru_builder,
    "rwkv6": rwkv6_builder,
}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Registry spec: a policy name plus builder kwargs, e.g.
    ``PolicyConfig("rglru", {"hidden": 16, "use_kernel": True})``."""
    name: str
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def build_policy(spec, n_features: int, n_actions: int, n_envs: int, *,
                 device=None, **overrides) -> ModelAdapter:
    """Resolve a registry name / :class:`PolicyConfig` to a certified
    :class:`~repro_torch.runtime.predictor.ModelAdapter` on ``device``
    (``None`` means the CUDA card). Certification probes the builder
    before the adapter is built and raises
    ``analysis.contracts.ContractViolation`` naming the rule ids; the
    certificate rides the adapter as ``adapter.certificate``."""
    if isinstance(spec, str):
        spec = PolicyConfig(spec)
    try:
        builder = POLICIES[spec.name]
    except KeyError:
        raise KeyError(
            f"Unrecognized policy provided: {spec.name!r} "
            f"(registered: {sorted(POLICIES)})") from None
    kwargs = dict(spec.kwargs)
    kwargs.update(overrides)
    device = resolve_device(device)
    bound = functools.partial(builder, **kwargs)
    from repro_torch.analysis.certify import certify_policy
    probes = ((4, n_features, n_actions),)
    key = None if "params" in kwargs else (
        spec.name, tuple(sorted(kwargs.items())), probes, device.type)
    cert = certify_policy(bound, probes, name=spec.name, device=device,
                          cache_key=key)
    adapter = bound(n_features, n_actions, n_envs=n_envs, device=device)
    adapter.certificate = cert
    return adapter
