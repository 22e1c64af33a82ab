"""The LM train, prefill and decode steps — port of ``repro.launch.steps``.

Each step is a pure function: it writes none of its inputs, so a caller
may keep the old params (a checkpoint, a comparison) while the new ones
are in use.

Train, ``step(params, opt_state, batch) -> (new_params, new_opt_state,
metrics)``:
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

Every step runs on a mesh (``mesh=``, a ``launch.mesh.ModelMesh``;
``perf``, a ``ShardingConfig``): ``mesh=None`` is a (1, 1) mesh over
``device``, where every collective is the identity, so the step computes
the one-device ops. Every tree is a tuple with one tree per shard
(``distribution.sharding.place_tree``) in the layouts the step's
``layouts`` dict names, the reference's shardings; on a one-shard mesh a
bare tree stands for its one-tuple, and bare trees come back:
  * ``perf.layout="zero3"``: params stored in ``zero1_shardings`` (the
    compute layout plus a data-axis split) and gathered to the compute
    layout per pattern group inside the step (``sharding.gather_hook``,
    under the group's remat), their gradients reduce-scattered back;
  * ``perf.layout="tp"``: params stored in the compute layout
    (``param_rules``), replicated over the data axes;
  * the AdamW state ``m`` and ``v`` in ``zero1_shardings`` (the param
    layout with ``perf.zero1=False``), the step counter on every shard;
  * a gradient is summed over the shards that hold copies of its block
    (``psum`` over the axes its storage spec leaves unused); the global
    grad norm is the sum of the shards' sums of squares over the blocks
    each holds first; AdamW then runs per shard on its block (it is
    elementwise) and, under ``tp``, the new blocks are gathered over the
    data axes back into the param layout;
  * microbatches are cut from the global batch (gathered over the data
    axes, sliced, split again), as the reference's reshape, and the
    gradients accumulate in the ZeRO layout.
Prefill and decode
(:func:`build_prefill_step`, :func:`build_decode_step`) place the cache by
``cache_rules`` and the logits by ``batch_sharding``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      ShardingConfig, TrainConfig)
from repro_torch.distribution import collectives as col
from repro_torch.distribution import sharding as shd
from repro_torch.models import LM
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tr


def loss_and_grads(model: LM, params, batch, split: bool = True):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params`` (a tuple
    of per-shard trees of the ``LM.params`` layout, or a bare tree on a
    one-shard mesh); grads have the params' form, tree and dtypes.
    ``split``: ``LM.loss``'s."""
    sharded = isinstance(params, tuple)
    shards = list(params) if sharded else [params]
    flats = [tr.flatten(p) for p in shards]
    with torch.enable_grad():
        live = [[x.detach().requires_grad_() for x in f] for f, _ in flats]
        trees = [tr.unflatten(td, lv) for (_, td), lv in zip(flats, live)]
        loss, metrics = model.loss(batch, params=tuple(trees) if sharded
                                   else trees[0], split=split)
        every = [x for lv in live for x in lv]
        grads = torch.autograd.grad(loss, every, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(every, grads)]
    out, k = [], 0
    for (f, td) in flats:
        out.append(tr.unflatten(td, grads[k:k + len(f)]))
        k += len(f)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tuple(out) if sharded else out[0])


def make_model(cfg: ModelConfig, perf: ShardingConfig = ShardingConfig(),
               mesh=None, *, device=None, seed: int = 0,
               remat_policy: Optional[str] = None, params=None) -> LM:
    """The ``LM`` of a step: over ``mesh`` with ``perf`` (``attn_sharding``
    resolved as the reference's ``make_model`` does), or on ``device``
    when ``mesh`` is None; weights from ``seed`` unless ``params``."""
    return LM(cfg, device=device, mesh=mesh, perf=perf, seed=seed,
              params=params, rwkv_chunk=perf.rwkv_chunk,
              remat_policy=remat_policy or perf.remat_policy)


def batch_layout(batch: dict, mesh, perf: ShardingConfig) -> dict:
    """Each input's spec: the batch dim over the data axes where it
    divides (``batch_sharding``)."""
    return {k: shd.batch_sharding(mesh, v.dim(), perf, batch_size=v.shape[0])
            for k, v in batch.items()}


def batch_split(mesh, perf: ShardingConfig, rows: int) -> bool:
    """Whether a global batch of ``rows`` is split over the data axes
    (:func:`batch_layout`'s decision; else every data shard holds it
    whole): ``LM``'s ``split``."""
    return shd.batch_sharding(mesh, 1, perf, batch_size=rows)[0] is not None


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def _extra_dims(have, want, mesh) -> list:
    """``(dim, axes)`` where spec ``want`` splits a dim ``have`` leaves
    whole (the ZeRO layout's data-axis split)."""
    out = []
    for d, p in enumerate(want):
        h = have[d] if d < len(have) else None
        if p is not None and p != h:
            out.append((d, p))
    return out


def _narrow_to(x, steps, mesh, i):
    for d, axes in steps:
        n = shd.axis_size(mesh, axes)
        per = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(i, axes) * per, per)
    return x


def _by_leaf(trees):
    """Per-shard trees -> (per-leaf lists over the shards, treedef)."""
    flats = [tr.flatten(t) for t in trees]
    return [list(c) for c in zip(*[f[0] for f in flats])], flats[0][1]


def _by_shard(cols, treedef, n):
    return tuple(tr.unflatten(treedef, [c[i] for c in cols])
                 for i in range(n))


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     tcfg: TrainConfig = TrainConfig(), device=None,
                     model: Optional[LM] = None, *, mesh=None,
                     perf: ShardingConfig = ShardingConfig()):
    """Returns ``(step, model)``: ``step(params, opt_state, batch)`` as the
    module docstring says, and the ``LM`` it runs (unless given, built
    here with ``tcfg.remat_policy`` and weights drawn from ``tcfg.seed``,
    over ``mesh`` with ``perf``, ``mesh=None`` meaning (1, 1) over
    ``device``, ``None`` meaning the card; a given model brings its own
    mesh). ``shape`` fixes the global batch, which must split into
    ``tcfg.microbatches``. ``step.layouts`` holds the spec trees of
    ``params``, ``opt_state`` and each microbatch's ``batch`` inputs (a
    function of the batch)."""
    nmicro = tcfg.microbatches
    if nmicro < 1 or shape.global_batch % nmicro:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {nmicro} microbatches")
    if perf.layout not in ("zero3", "tp"):
        raise ValueError(f"layout {perf.layout!r} not in ('zero3', 'tp')")
    if model is None:
        model = make_model(cfg, perf, mesh, device=device, seed=tcfg.seed,
                           remat_policy=tcfg.remat_policy)
    mesh = model.mesh
    split = batch_split(mesh, perf, shape.global_batch // nmicro)
    defs = model.param_defs()
    compute = model.param_specs()
    zero = shd.zero1_shardings(defs, mesh, perf)
    if perf.layout == "zero3":
        store = zero
        n_grp = cfg.n_groups * len(cfg.layer_pattern)
        model.gather_embed = shd.gather_hook(mesh, store["embed"],
                                             compute["embed"])
        if cfg.n_groups:
            n_pat = len(cfg.layer_pattern)
            model.gather_group = shd.gather_hook(
                mesh, store["layers"][:n_pat], compute["layers"][:n_pat])
        if n_grp < cfg.n_layers:
            model.gather_tail = shd.gather_hook(
                mesh, store["layers"][n_grp:], compute["layers"][n_grp:])
    else:
        store = compute
    st_leaves = shd.spec_leaves(store)
    z_leaves = shd.spec_leaves(zero)
    # per leaf: the axes whose shards hold copies of one stored block, and
    # the narrowing from the stored block to the ZeRO block
    replica_axes = [tuple(a for a in mesh.axis_names
                          if a not in shd.spec_axes(s)) for s in st_leaves]
    to_zero = [_extra_dims(s, z, mesh) for s, z in zip(st_leaves, z_leaves)]
    # the shards that hold each ZeRO block first (index 0 on the axes the
    # block is replicated over): the grad norm counts each block once
    first = [[all(mesh.axis_index(i, a) == 0 for a in mesh.axis_names
                  if a not in shd.spec_axes(z)) for i in range(mesh.size)]
             for z in z_leaves]
    n = mesh.size
    dev0 = mesh.device(0)

    def zero_grads(grads):
        """Stored-layout grads -> summed over replicas -> ZeRO blocks."""
        cols, treedef = _by_leaf(grads)
        for k, axes in enumerate(replica_axes):
            if axes:
                cols[k] = col.psum(cols[k], mesh, axes)
            cols[k] = [_narrow_to(g, to_zero[k], mesh, i)
                       for i, g in enumerate(cols[k])]
        return _by_shard(cols, treedef, n)

    def micro_batches(batch):
        """The microbatches of the global batch (gathered in key order,
        cut on rows, each split over the data axes again)."""
        if nmicro == 1:
            return [batch]
        b0 = batch[0]
        specs = [shd.batch_sharding(mesh, b0[k].dim(), perf,
                                    batch_size=shape.global_batch)
                 for k in sorted(b0)]
        whole = shd.gather_tree(batch, specs, mesh)
        mb = shape.global_batch // nmicro
        out = []
        for j in range(nmicro):
            part = {k: v[j * mb:(j + 1) * mb] for k, v in whole.items()}
            out.append(shd.place_tree(part, batch_layout(part, mesh, perf),
                                      mesh))
        return out

    def step(params, opt_state, batch):
        if not isinstance(params, tuple):       # a bare tree, one shard
            p, o, metrics = step((params,), (opt_state,), (batch,))
            return p[0], o[0], metrics
        if len(params) != n or len(batch) != n:
            raise ValueError(f"a mesh of {n} shards takes {n} trees")
        with torch.no_grad():
            acc = None
            losses, metricses = [], []
            for part in micro_batches(batch):
                with torch.enable_grad():
                    loss, metrics, g = loss_and_grads(model, params, part,
                                                      split)
                g = zero_grads(g)
                if nmicro > 1:
                    g = tuple(tr.map_(lambda x: x.float(), t) for t in g)
                    acc = g if acc is None else tuple(
                        tr.map_(lambda a, x: a + x, a_t, g_t)
                        for a_t, g_t in zip(acc, g))
                else:
                    acc = g
                losses.append(loss)
                metricses.append(metrics)
            if nmicro > 1:
                acc = tuple(tr.map_(lambda a: a / torch.full(
                    (), float(nmicro), dtype=torch.float32, device=a.device),
                    t) for t in acc)
                loss = torch.stack(losses).mean()
                metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                           for k in metricses[0]}
            # the global norm: each shard's sum of squares over the blocks
            # it holds first, summed in shard order
            sq = []
            for i, g in enumerate(acc):
                own = [torch.sum(torch.square(x.to(torch.float32)))
                       for k, x in enumerate(tr.leaves(g)) if first[k][i]]
                if own:
                    sq.append(torch.sum(torch.stack(own)))
            gnorm = torch.sqrt(col.ordered_sum(sq))
            pcols, ptd = _by_leaf(params)
            blocks = _by_shard([[_narrow_to(x, to_zero[k], mesh, i)
                                 for i, x in enumerate(c)]
                                for k, c in enumerate(pcols)], ptd, n)
            outs = [opt_lib.update(g, o, p, tcfg, gnorm=gnorm.to(
                mesh.device(i))) for i, (g, o, p) in
                enumerate(zip(acc, opt_state, blocks))]
            new_params = tuple(o[0] for o in outs)
            if perf.layout == "tp":
                cols, td = _by_leaf(new_params)
                for k, steps in enumerate(to_zero):
                    for d, axes in steps:
                        cols[k] = col.all_gather(cols[k], mesh, axes, d)
                new_params = _by_shard(cols, td, n)
            new_opt = tuple(o[1] for o in outs)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm.to(dev0),
                           lr=opt_lib.schedule(tcfg, new_opt[0]["step"]))
        return new_params, new_opt, metrics

    step.layouts = {
        "params": store,
        "opt": {"m": zero, "v": zero, "step": ()},
        "batch": lambda batch: batch_layout(batch, mesh, perf),
    }
    return step, model


def init_opt_state(params, mesh, layouts):
    """AdamW's zero state for ``params`` on ``mesh``: ``m`` and ``v`` in
    ``layouts["opt"]``'s blocks, the step on every shard. ``params``: the
    global tree."""
    opt = opt_lib.init(params)
    specs = {"m": layouts["opt"]["m"], "v": layouts["opt"]["v"],
             "step": ()}
    return shd.place_tree(opt, specs, mesh, copy=True)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def _serve_model(cfg, perf, mesh, device, model, seed):
    if model is None:
        model = make_model(cfg, perf, mesh, device=device, seed=seed)
    return model


def _serve_layouts(model, shape, perf):
    B, mesh = shape.global_batch, model.mesh
    return {"params": model.param_specs(),
            "batch": lambda batch: batch_layout(batch, mesh, perf),
            "cache": model.cache_specs(B, shape.seq_len),
            "logits": shd.batch_sharding(mesh, 2, perf, batch_size=B)}


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       perf: ShardingConfig = ShardingConfig(), *,
                       device=None, model: Optional[LM] = None,
                       seed: int = 0):
    """Returns ``(step, model)``: ``step(params, batch) -> (logits,
    cache)`` (``model.prefill`` with the cache sized to the prompt); on a
    mesh every tree a tuple of per-shard trees in ``step.layouts``."""
    model = _serve_model(cfg, perf, mesh, device, model, seed)
    split = batch_split(model.mesh, perf, shape.global_batch)

    def step(params, batch):
        return model.prefill(batch, params=params, split=split)

    step.layouts = _serve_layouts(model, shape, perf)
    return step, model


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                      perf: ShardingConfig = ShardingConfig(), *,
                      device=None, model: Optional[LM] = None,
                      seed: int = 0):
    """Returns ``(step, model)``: ``step(params, batch, cache) -> (logits,
    new cache)`` against a cache of ``shape.seq_len`` slots; on a mesh
    every tree a tuple of per-shard trees in ``step.layouts``, the cache
    written by its slots' owners (``cache.write_local``)."""
    model = _serve_model(cfg, perf, mesh, device, model, seed)
    split = batch_split(model.mesh, perf, shape.global_batch)

    def step(params, batch, cache):
        return model.decode_step(batch, cache, params=params, split=split,
                                 max_seq=shape.seq_len)

    step.layouts = _serve_layouts(model, shape, perf)
    return step, model


def build_step(kind: str, cfg, shape, mesh=None, perf=ShardingConfig(),
               tcfg=TrainConfig(), **kw):
    if kind == "train":
        return build_train_step(cfg, shape, tcfg, mesh=mesh, perf=perf, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, perf, **kw)
    if kind == "decode":
        return build_decode_step(cfg, shape, mesh, perf, **kw)
    raise ValueError(kind)
