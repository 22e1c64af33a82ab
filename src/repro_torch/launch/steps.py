"""The LM train step — port of ``repro.launch.steps.build_train_step`` on
one device (no mesh: the model-sharding half is ROADMAP queue 1 item 13b).

The step is a pure function over trees of the ``LM.params`` layout:
``step(params, opt_state, batch) -> (new_params, new_opt_state,
metrics)``. It writes none of its inputs, so a caller may keep the old
params (a checkpoint, a comparison) while the new ones are in use.

  * ``tcfg.microbatches`` > 1: the batch splits on its leading dim into
    that many microbatches; each one's gradient is added into float32
    accumulators in turn, and the sum is divided by the count; the loss
    and the metrics are the means over the microbatches. One microbatch
    takes the gradient as it comes (in the params' dtype), as there.
  * The update is the port's pure AdamW (``train.optimizer.update``).
  * Metrics: ``ce``, ``aux``, ``loss``, ``grad_norm`` and ``lr`` (the
    schedule at the new step), float32 device scalars: nothing is read
    back to the host.

A param the loss does not read (the token table of an ``embeddings``
model) gets a zero gradient, as ``jax.grad`` gives it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tr


def loss_and_grads(model: LM, params, batch):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params`` (a tree of
    the ``LM.params`` layout); grads have the params' tree and dtypes."""
    flat, treedef = tr.flatten(params)
    with torch.enable_grad():
        live = [x.detach().requires_grad_() for x in flat]
        loss, metrics = model.loss(batch, params=tr.unflatten(treedef, live))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tr.unflatten(treedef, grads))


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     tcfg: TrainConfig = TrainConfig(), device=None,
                     model: Optional[LM] = None):
    """Returns ``(step, model)``: ``step(params, opt_state, batch)`` as the
    module docstring says, and the ``LM`` it runs (unless given, built
    here on ``device``, ``None`` meaning the card, with
    ``tcfg.remat_policy`` and weights drawn from ``tcfg.seed``).
    ``shape`` fixes the global batch, which must split into
    ``tcfg.microbatches``."""
    device = resolve_device(device)
    if model is None:
        model = LM(cfg, device=device, seed=tcfg.seed,
                   remat_policy=tcfg.remat_policy)
    nmicro = tcfg.microbatches
    if nmicro < 1 or shape.global_batch % nmicro:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {nmicro} microbatches")

    def step(params, opt_state, batch):
        if nmicro > 1:
            B = next(iter(batch.values())).shape[0]
            mb = B // nmicro
            acc = tr.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
            losses, metricses = [], []
            for i in range(nmicro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, metrics, g = loss_and_grads(model, params, part)
                acc = tr.map_(lambda a, x: a + x, acc, g)
                losses.append(loss)
                metricses.append(metrics)
            n = torch.full((), float(nmicro), dtype=torch.float32,
                           device=device)
            grads = tr.map_(lambda g: g / n, acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        with torch.no_grad():
            new_params, new_opt, gnorm = opt_lib.update(grads, opt_state,
                                                        params, tcfg)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                           lr=opt_lib.schedule(tcfg, new_opt["step"]))
        return new_params, new_opt, metrics

    return step, model
