"""AdamW built from scratch — port of ``repro.train.optimizer``.

Not ``torch.optim.AdamW``: that one updates ``p`` in place, applies the
decay as a separate ``p *= 1 - lr * wd`` and divides by the bias
corrections in another place, so its bits differ from the reference's.
Here the arithmetic is the reference's: float32 state, bias corrections
``1 - b ** step`` on the float32 step, the decay added inside ``delta``,
``max(norm, 1e-12)`` in the global-norm clip. Leaves are visited in
``jax.tree.flatten``'s order (``train.tree``).

Every function is pure: it returns new tensors and writes none of its
inputs, so a params tree the decide carry still holds is never changed
under it (the online trainer's hot-swap relies on this).

Each division by a configuration scalar divides by a 0-d tensor on the
operand's device: PyTorch on CUDA divides by a Python scalar as a multiply
by its reciprocal, which is not the rounding of a division.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.train import tree


def _div(x, c: float):
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def schedule(cfg: TrainConfig, step):
    """Linear warmup, then cosine decay to 10% of ``learning_rate``."""
    step = step.to(torch.float32)
    warm = torch.clamp(_div(step, max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(_div(step - cfg.warmup_steps,
                         max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def init(params):
    """float32 zeros for ``m`` and ``v``, and an int32 step of 0."""
    flat = tree.leaves(params)
    device = flat[0].device if flat else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree.map_(zeros, params), "v": tree.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(t):
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree.leaves(t)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree.map_(lambda g: g * scale.to(g.dtype), grads), norm


def update(grads, opt_state, params, cfg: TrainConfig, gnorm=None):
    """One AdamW step. Returns ``(new_params, new_opt_state, grad_norm)``.
    ``gnorm``: the global gradient norm, when the caller holds a block of
    the trees (a mesh shard) and computed it over all of them; default
    :func:`global_norm` of ``grads``.

    The clip and the update run leaf by leaf, each temporary dropped as
    soon as it is used, so the step's peak holds about three float32
    copies of the largest leaf besides the state (a 2.7 B-param model's
    embedding is 2.6 GB in float32); the arithmetic is
    :func:`clip_by_global_norm`'s and the reference's, op for op."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = (g * scale.to(g.dtype)).to(torch.float32)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * torch.square(g)
        del g
        p32 = p.to(torch.float32)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    flat_p, treedef = tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree.leaves(grads), tree.leaves(opt_state["m"]),
        tree.leaves(opt_state["v"]))]
    new = [tree.unflatten(treedef, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, gnorm
