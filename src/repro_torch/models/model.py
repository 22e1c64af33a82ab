"""The LM — port of ``repro.models.model``.

``LM`` is an ``nn.Module`` holding its weights; the config's
``layer_pattern`` picks each layer's block. Two serving entry points, the
reference's pair:
  * ``prefill(inputs, max_seq=None)`` — the whole prompt at once (one
    flash-attention launch per attention layer, one ``rglru_scan`` launch
    per RG-LRU layer); returns the last position's logits and a filled
    cache;
  * ``decode_step(inputs, cache)`` — one token per sample against the
    cache.
Every block of the reference serves: global and local (ring-cache)
attention, the RG-LRU block, the RWKV-6 block (its channel-mix in place of
the FFN; ``rwkv_chunk`` picks the sequential or the chunked wkv at
prefill), the dense SwiGLU MLP and the MoE FFN, with the ``embeddings``
(``frames`` in) and ``vlm`` (``patches`` before the tokens at prefill)
frontends. Layers are an ``nn.ModuleList`` in model order, where the
reference scans over stacked pattern groups and runs the remainder as
``tail`` layers (``convert.lm_params_from_numpy`` maps one layout onto the
other).

Training: ``loss(batch, params=None)`` is the reference's train entry
point (vlm text positions only, the next-token shift, the MoE aux loss
added). It runs ``backbone(mode="train")``, which checkpoints each group
of ``len(cfg.layer_pattern)`` layers as the reference's scanned groups
(``remat_policy``: ``none``; ``full``, ``torch.utils.checkpoint``;
``dots``, the matmul outputs saved through a selective-checkpoint policy)
and runs the remainder (``tail``) layers plainly, as there. Serving
freezes every param (``requires_grad=False``); training asks for grads
on a tree of the :meth:`params` layout and runs ``loss(params=tree)``
(the train step's functional form).

On a mesh (``mesh=``, a ``launch.mesh.ModelMesh``, with ``perf``, a
``ShardingConfig``) the LM runs SPMD over the mesh's shards, the
counterpart of the reference's GSPMD program with its sharding hooks:
every activation is a list with one tensor per shard, each shard runs the
block on its own blocks, and ``distribution.collectives`` combines them.
The planner (``distribution.sharding.param_rules``) decides every
param's layout and the executor follows it:
  * ``data`` (and ``pod``) split the batch; the loss sums over them;
  * attention, by ``attn_sharding`` (``auto``: ``heads`` where the heads
    divide ``model``, ``ctx`` otherwise, as the reference's
    ``make_model``):
      - ``heads``: each ``model`` shard holds its block of q heads (one
        flash launch per shard at (B/n_dp, S, H/m, D)); where the kv heads
        do not divide, each shard computes them whole and repeats them to
        its q heads, as the reference repeats KV;
      - ``heads`` where the q heads do not divide (the reference's
        constraint falls back to the batch): every shard computes every
        head over every row from the gathered q columns, then keeps its
        ``heads_flat`` columns;
      - ``ctx`` (context parallelism): an ``all_to_all`` takes the q
        projection's column blocks to row blocks, so shard j holds every
        head over its rows [j qc, (j + 1) qc), qc = ceil(S / m), and the
        kv heads whole; one flash launch per shard at ``q_offset`` = j qc
        (none for an empty chunk), the output taken back to column blocks
        by a second ``all_to_all``;
    the output projection is row-parallel, then a ``psum``. Decode attends
    over whole heads where the heads do not divide;
  * the MLP is column-parallel (``d_ff``) then row-parallel, then a
    ``psum``; the MoE is expert-parallel (``moe.moe_shards``); the RG-LRU
    block splits ``lru_width`` (one ``rglru_scan`` launch per shard at
    width W/m) with a row-parallel output; the RWKV-6 block splits its
    heads (the time-mix and its ``wkv`` state) and ``d_ff`` (the
    channel-mix), as :meth:`LM._rwkv_block` says;
  * ``seq_parallel``: where S divides over ``model``, the residual stream
    lives split on S between blocks; each block all-gathers its normed
    input on S and reduce-scatters its row-parallel output on S in place
    of the ``psum`` (norms and residual adds on the shard's rows);
  * the embedding and the head split the vocab (the cross entropy is
    vocab-parallel: each shard's logsumexp and target logit, combined
    across shards) or, where the planner puts them on ``d_model``, are
    gathered whole; the ``embeddings`` frontend's frames and the ``vlm``
    frontend's patches come split over the data axes and whole over
    ``model``;
  * decode attention over a cache split on ``cache_seq`` combines the
    shards' partial softmaxes; only a slot's owner writes it;
  * a leaf the block needs whole (norm weights, the router, a weight the
    planner split another way than the block's fast path) is gathered.
One shard (``mesh=None``, or a (1, 1) mesh) runs exactly the unsharded
ops: every collective of a group of one is the identity.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV,
                                      ModelConfig, ShardingConfig)
from repro_torch.device import resolve_device
from repro_torch.distribution import collectives as col
from repro_torch.distribution import sharding as shd
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.moe import moe_apply, moe_defs, moe_shards
from repro_torch.models.rglru import rglru_apply, rglru_defs, rglru_step
from repro_torch.models.rwkv6 import (cm_gate, cm_key, cm_mix, rwkv_defs,
                                      time_mix_out, time_mix_step_wkv,
                                      time_mix_wkv)
from repro_torch.train import tree as tr

_FRONTENDS = ("none", "embeddings", "vlm")


def _check_config(cfg: ModelConfig) -> None:
    for kind in set(cfg.layer_kinds):
        if kind not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV):
            raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


def attn_mode(cfg: ModelConfig, perf: ShardingConfig, msize: int) -> str:
    """The reference's choice: ``auto`` gives ``heads`` when the heads
    divide the ``model`` axis, ``ctx`` otherwise."""
    if perf.attn_sharding == "auto":
        return "heads" if (cfg.n_heads == 0 or cfg.n_heads % msize == 0) \
            else "ctx"
    return perf.attn_sharding


def check_mesh(cfg: ModelConfig, perf: ShardingConfig, msize: int) -> None:
    """Raise on a mesh option the port does not know (the reference reads
    any ``attn_sharding`` other than ``heads`` as ``ctx``; the port
    refuses it by name)."""
    if attn_mode(cfg, perf, msize) not in ("heads", "ctx"):
        raise ValueError(f"attn_sharding {perf.attn_sharding!r}")


def layer_defs(cfg: ModelConfig, kind: str) -> dict:
    """One layer's param defs: ``{"attn", "ffn"}``, ``{"rglru", "ffn"}``
    or ``{"rwkv"}`` (its channel-mix included), ``ffn`` the dense MLP or
    the MoE FFN."""
    if kind == RWKV:
        return {"rwkv": rwkv_defs(cfg)}
    d = {"rglru": rglru_defs(cfg)} if kind == RGLRU else \
        {"attn": L.attention_defs(cfg)}
    d["ffn"] = moe_defs(cfg) if cfg.moe is not None else L.mlp_defs(cfg)
    return d


def param_defs(cfg: ModelConfig) -> dict:
    """The LM's param defs in the port layout (layers in model order)."""
    return {"embed": L.embed_defs(cfg),
            "layers": [layer_defs(cfg, k) for k in cfg.layer_kinds]}


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The decode cache's defs: ``lengths`` and, per layer, its k/v (a
    ring of ``local_window`` slots for local attention), RG-LRU or RWKV
    state."""
    def layer(kind):
        if kind == RGLRU:
            return cache_lib.rglru_cache_defs(cfg, batch)
        if kind == RWKV:
            return cache_lib.rwkv_cache_defs(cfg, batch)
        return cache_lib.kv_cache_defs(
            cfg, batch, max_seq,
            window=cfg.local_window if kind == ATTN_LOCAL else 0)

    return {"lengths": P.ParamDef((batch,), ("batch",), torch.int32,
                                  "zeros"),
            "layers": [layer(k) for k in cfg.layer_kinds]}


REMAT_POLICIES = ("none", "dots", "full")
# the ops whose outputs ``remat_policy="dots"`` keeps: the 2-D matmuls
# (an activation times a weight), as the reference's
# ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _frozen(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


_COL = (None, "model")       # split on its last (output) dim
_ROW = ("model", None)       # split on its first (input) dim


class LM(nn.Module):
    """A decoder-only LM over ``cfg`` on ``device`` (``None`` = CUDA), or
    over ``mesh``'s shards (module docstring).

    Weights come from ``params`` (the port layout, e.g. from
    ``convert.lm_params_from_numpy``) or, without it, are drawn from a
    ``torch.Generator`` on ``device`` (a mesh: its first shard's device)
    seeded with ``seed``. ``rwkv_chunk`` > 1 runs the RWKV wkv chunkwise at
    prefill (0: the exact sequential recurrence), as the reference's
    constructor. ``moe_counts``, when set to a list, receives each MoE
    call's (dropped, total) assignment counts as device tensors.
    ``remat_policy`` (``none | dots | full``) is the train mode's
    checkpointing.

    ``mesh`` is the model's ``launch.mesh.ModelMesh``: ``mesh=None``
    makes it (1, 1) over ``device``. The entry points take and give
    tuples with one tree per shard (``distribution.sharding.place_tree``
    with :meth:`param_specs`, :meth:`cache_specs` and
    ``launch.steps.batch_layout``); on a one-shard mesh a bare tree stands
    for its one-tuple, and bare trees come back. ``params=None`` means the
    module's weights, split into views. ``split``: whether the batch is
    split over the data axes (``launch.steps.batch_layout`` decides; else
    every data shard holds it whole). ``gather_group``,
    ``gather_tail`` and ``gather_embed`` (``sharding.gather_hook``, set by
    the ZeRO-3 train step) map params stored in another layout to
    :meth:`param_specs`' inside the step, per pattern group, as the
    reference's hooks.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, params=None,
                 seed: int = 0, rwkv_chunk: int = 0,
                 remat_policy: str = "full", mesh=None,
                 perf: ShardingConfig = ShardingConfig()):
        super().__init__()
        _check_config(cfg)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        self.cfg = cfg
        self.rwkv_chunk = rwkv_chunk
        self.remat_policy = remat_policy
        self.moe_counts = None
        self.perf = perf
        if mesh is None:
            from repro_torch.launch.mesh import make_mesh
            self.device = resolve_device(device)
            mesh = make_mesh((1, 1), devices=[self.device])
        else:
            self.device = mesh.device(0)
        self.mesh = mesh
        self.msize = self.mesh.shape.get("model", 1)
        self.dp = shd.dp_axes(self.mesh)
        check_mesh(cfg, perf, self.msize)
        self.gather_group = self.gather_tail = self.gather_embed = None
        defs = self.param_defs()
        rules = shd.param_rules(perf)
        self._embed_spec = shd.tree_shardings(defs["embed"], self.mesh,
                                              rules)
        self._layer_spec = {k: shd.tree_shardings(layer_defs(cfg, k),
                                                  self.mesh, rules)
                            for k in set(cfg.layer_kinds)}
        if params is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
            params = P.init(defs, generator, self.device)
        else:
            _check_params(defs, params)
        self.embed = _frozen(params["embed"])
        self.layers = nn.ModuleList(
            nn.ModuleDict({k: _frozen(v) for k, v in layer.items()})
            for layer in params["layers"])
        self.to(self.device)

    def params(self) -> dict:
        """The module's weights as a tree of the port layout
        (``{"embed": {...}, "layers": [layer, ...]}``), the tensors
        themselves (no copy)."""
        return {"embed": dict(self.embed),
                "layers": [{k: dict(v) for k, v in layer.items()}
                           for layer in self.layers]}

    def load_params(self, tree) -> None:
        """Point the module's params at ``tree``'s tensors (the
        :meth:`params` layout, same shapes and dtypes; no copy). Called
        with a one-device step's new params, the module serves the trained
        weights and the ones it held before are freed."""
        _check_params(self.param_defs(), tree)
        for p, t in zip(tr.leaves(self.params()), tr.leaves(tree)):
            p.data = t.detach()

    # ------------------------------------------------------------ params
    def param_defs(self) -> dict:
        return param_defs(self.cfg)

    def param_count(self) -> int:
        return P.count(self.param_defs())

    def param_bytes(self) -> int:
        return P.bytes_of(self.param_defs())

    def param_specs(self) -> dict:
        """The compute layout of the params on the mesh (the planner's
        ``param_rules``), a spec tree of the :meth:`params` layout."""
        return {"embed": self._embed_spec,
                "layers": [self._layer_spec[k] for k in self.cfg.layer_kinds]}

    def shard_params(self, tree=None) -> tuple:
        """``tree`` (default the module's weights) split per
        :meth:`param_specs`, one tree per shard (views where the device
        allows)."""
        tree = self.params() if tree is None else tree
        return shd.place_tree(tree, self.param_specs(), self.mesh)

    # ------------------------------------------------------------- cache
    def _window(self, kind: str) -> int:
        return self.cfg.local_window if kind == ATTN_LOCAL else 0

    def cache_defs(self, batch: int, max_seq: int) -> dict:
        return cache_defs(self.cfg, batch, max_seq)

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """The cache's layout on the mesh (``cache_rules``)."""
        return shd.tree_shardings(self.cache_defs(batch, max_seq),
                                  self.mesh, shd.cache_rules(self.perf))

    def init_cache(self, batch: int, max_seq: int) -> dict:
        return P.init(self.cache_defs(batch, max_seq), None, self.device)

    # ------------------------------------------------------- SPMD helpers
    @property
    def _split(self) -> bool:
        return self.msize > 1

    def _full(self, xs, spec):
        """A leaf's blocks gathered whole on every shard."""
        for d, p in enumerate(spec):
            if p is not None:
                xs = col.all_gather(xs, self.mesh, p, d)
        return xs

    def _leaf(self, ps, key):
        return [p[key] for p in ps]

    def _psum(self, xs):
        return col.psum(xs, self.mesh, "model")

    def _model_block(self, x, i, kind=None, spec=None):
        """Shard ``i``'s block of ``x`` (whole on ``model``, already its
        own on the data axes) along the dims ``spec`` (default: the layout
        of ``kind``'s k/v cache of x's slots) puts on ``model``."""
        if not self._split:
            return x
        if spec is None:
            spec = self._kv_cache_spec(kind, x.shape[1])
        for d, p in enumerate(spec):
            axes = p if isinstance(p, tuple) else (p,)
            if p is not None and "model" in axes:
                n = self.msize
                per = x.shape[d] // n
                x = x.narrow(d, self.mesh.axis_index(i, "model") * per, per)
        return x

    def _heads_block(self, x, i):
        """Shard ``i``'s block of heads (dim 2) of ``x``."""
        per = x.shape[2] // self.msize
        return x.narrow(2, self.mesh.axis_index(i, "model") * per, per)

    def _data_sum(self, xs, split: bool):
        """A per-shard partial summed over the data axes (the batch is
        split), or each shard's own (the batch is replicated)."""
        return col.psum(xs, self.mesh, self.dp) if split else list(xs)

    # ------------------------------------------------------------ blocks
    def _enter(self, hs, sp):
        """A block's normed input whole on S: under ``seq_parallel`` (``sp``)
        the shards' rows all-gathered, else as it is."""
        return col.all_gather(hs, self.mesh, "model", 1) if sp else hs

    def _exit(self, outs, sp):
        """A row-parallel output's partial sums combined over ``model``:
        the ``psum``, or under ``seq_parallel`` its ``reduce_scatter`` on S
        (each shard the sum over its rows)."""
        if sp:
            return col.reduce_scatter(outs, self.mesh, "model", 1)
        return self._psum(outs)

    def _rows(self, xs, sp):
        """A value every shard holds whole on S narrowed, under
        ``seq_parallel``, to each shard's rows."""
        if not sp:
            return xs
        return [self._model_block(x, i, spec=(None, "model"))
                for i, x in enumerate(xs)]

    def _seq_split(self, S: int, mode: str) -> bool:
        """Whether the residual stream splits on S over ``model`` between
        blocks (the reference's ``constrain_batch``): ``seq_parallel`` on a
        mesh with ``model`` > 1 whose size divides S; a decode step (S = 1)
        never splits."""
        return (self.perf.seq_parallel and self._split and mode != "decode"
                and S % self.msize == 0)

    def _flat_block(self, a, i):
        """Shard ``i``'s ``heads_flat`` columns of ``a`` (B, S, H, Dh) or
        (B, S, H * Dh): the rows of its block of ``wo``, as (B, S, cols)."""
        a = a.reshape(a.shape[:2] + (-1,))
        per = a.shape[2] // self.msize
        return a.narrow(2, self.mesh.axis_index(i, "model") * per, per)

    def _ctx_rows(self, S: int) -> list:
        """Context parallelism's query chunks: ``(start, rows)`` of each
        ``model`` index j, rows [j qc, min((j + 1) qc, S)) with qc =
        ceil(S / model), as the reference's ``nq = model`` chunks (a chunk
        past S is empty)."""
        qc = -(-S // self.msize)
        out = []
        for j in range(self.msize):
            r0 = min(j * qc, S)
            out.append((r0, min(qc, S - r0)))
        return out

    def _attn_split(self) -> str:
        """How prefill and train attention split over ``model``: ``heads``
        (each shard its block of q heads), ``ctx`` (each shard its query
        rows, every head) or ``whole`` (every shard every head and row,
        then its columns: ``heads`` mode where the heads do not divide)."""
        if not self._split:
            return "heads"
        if attn_mode(self.cfg, self.perf, self.msize) == "ctx":
            return "ctx"
        return "heads" if self.cfg.n_heads % self.msize == 0 else "whole"

    def _attn_block(self, ps, xs, kind, pos, mode, slots, lengths, sp,
                    max_seq=None):
        """``slots``: per shard, the layer's cache (decode) or its size
        (prefill). ``sp``: the residual stream is split on S. ``max_seq``:
        the decode cache's size (:meth:`decode_step`)."""
        cfg = self.cfg
        spec = self._layer_spec[kind]["attn"]
        window = self._window(kind)
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        m = self.msize
        n = len(xs)
        how = "decode" if mode == "decode" else self._attn_split()
        norm = self._full(self._leaf(ps, "norm"), spec["norm"])
        hs = [L.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, norm)]
        hs = self._enter(hs, sp)
        local_kv = not self._split or (spec["wk"] == _COL and Hkv % m == 0)
        if self._split:
            assert spec["wq"] == _COL and spec["wo"] == _ROW, spec
        if not local_kv:
            wk = self._full(self._leaf(ps, "wk"), spec["wk"])
            wv = self._full(self._leaf(ps, "wv"), spec["wv"])
            ps = [dict(p, wk=a, wv=b) for p, a, b in zip(ps, wk, wv)]
        if mode == "decode":
            pos = [lg[:, None] for lg in lengths]
        if how == "heads" or not self._split:
            qkv = [L.attention_qkv(p, h, cfg, q_pos)
                   for p, h, q_pos in zip(ps, hs, pos)]
            qs, ks, vs = (list(t) for t in zip(*qkv))
        else:
            # k, v of the shard's kv heads (or all of them), and q as its
            # heads_flat columns, reassembled below
            kv = [(L.heads_of(h @ p["wk"].to(h.dtype), p.get("k_norm"), cfg,
                              q_pos),
                   (h @ p["wv"].to(h.dtype)).reshape(h.shape[:2] + (-1, Dh)))
                  for p, h, q_pos in zip(ps, hs, pos)]
            ks, vs = (list(t) for t in zip(*kv))
            q_cols = [h @ p["wq"].to(h.dtype) for p, h in zip(ps, hs)]
            qn = self._full([p.get("q_norm") for p in ps],
                            spec["q_norm"]) if cfg.qk_norm else [None] * n
        kv_full = None
        if self._split and (mode != "train" or how != "heads"):
            # the kv heads whole per shard: the cache holds them all, and
            # ctx / whole attention reads every head
            kv_full = (ks, vs) if not local_kv else (
                col.all_gather(ks, self.mesh, "model", 2),
                col.all_gather(vs, self.mesh, "model", 2))
        if mode == "decode":
            q_full = None
            if self._split:
                q_full = [L.heads_of(q, w, cfg, q_pos) for q, w, q_pos in
                          zip(col.all_gather(q_cols, self.mesh, "model", 2),
                              qn, pos)]
            attn, new = self._decode_attn(kind, None if self._split else qs,
                                          ks, vs, kv_full, slots, lengths,
                                          q_full, max_seq)
        else:
            if how == "heads":
                attn = self._heads_attn(qs, ks, vs, local_kv, window)
            elif how == "ctx":
                attn = self._ctx_attn(q_cols, qn, pos, kv_full, window)
            else:
                attn = self._whole_attn(q_cols, qn, pos, kv_full, window)
            new = None
            if mode == "prefill":
                kf, vf = kv_full if kv_full is not None else (ks, vs)
                new = [{"k": self._model_block(
                            cache_lib.fill_from_prefill(k, size, window), i,
                            kind),
                        "v": self._model_block(
                            cache_lib.fill_from_prefill(v, size, window), i,
                            kind)}
                       for i, (k, v, size) in enumerate(zip(kf, vf, slots))]
        outs = [L.attention_out(p, a, x.dtype)
                for p, a, x in zip(ps, attn, hs)]
        outs = self._exit(outs, sp)
        if cfg.post_norms:
            pn = self._full(self._leaf(ps, "post_norm"), spec["post_norm"])
            outs = [L.rms_norm(o, w, cfg.norm_eps) for o, w in zip(outs, pn)]
        return [x + o for x, o in zip(xs, outs)], \
            (new if new is not None else [None] * n)

    def _kv_cache_spec(self, kind, size):
        """The layout (``cache_rules``) of an attention layer's k or v
        cache sized for ``size`` positions (a ring: its window at most)."""
        d = cache_lib.kv_cache_defs(self.cfg, 1, size,
                                    window=self._window(kind))["k"]
        return shd.resolve(d.shape, d.dims, self.mesh,
                           shd.cache_rules(self.perf))

    def _decode_attn(self, kind, qs, ks, vs, kv_full, slots, lengths,
                     q_full, max_seq):
        """Decode attention: one shard as the reference's; on a mesh from
        ``q_full`` (every head on every shard) against the cache's layout
        (``cache_rules`` at ``max_seq``: a block's shape alone does not say
        whether its slots or its kv heads are split), each shard keeping
        its ``heads_flat`` columns."""
        cfg = self.cfg
        window = self._window(kind)
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        G = H // Hkv
        sc = cfg.attn_logit_softcap
        if not self._split:
            attn, new = [], []
            for q, k, v, c, lg in zip(qs, ks, vs, slots, lengths):
                B = q.shape[0]
                ck = cache_lib.write_token(c["k"], k, lg, window)
                cv = cache_lib.write_token(c["v"], v, lg, window)
                kv_pos, kv_valid = cache_lib.slot_positions(
                    lg + 1, ck.shape[1], window)
                a = L.decode_attention(
                    q.reshape(B, 1, Hkv, G, Dh), ck.to(q.dtype),
                    cv.to(q.dtype), kv_positions=kv_pos, kv_valid=kv_valid,
                    q_position=lg, window=window, softcap=sc)
                attn.append(a)
                new.append({"k": ck, "v": cv})
            return attn, new
        cspec = self._kv_cache_spec(kind, max_seq)
        size = min(window, max_seq) if window else max_seq
        s_loc = size // self.msize if cspec[1] is not None else size
        kf, vf = kv_full
        attn, new = [], []
        if cspec[1] is not None:
            # the cache's slots split over model: the owner writes, each
            # shard attends over its slots, the partials combine
            parts = []
            for i, (q, k, v, c, lg) in enumerate(zip(q_full, kf, vf, slots,
                                                     lengths)):
                B = q.shape[0]
                off = self.mesh.axis_index(i, "model") * s_loc
                idx = cache_lib.write_index(lg, size, window)
                ck = cache_lib.write_local(c["k"], k, idx, off)
                cv = cache_lib.write_local(c["v"], v, idx, off)
                kv_pos, kv_valid = cache_lib.slot_positions(lg + 1, size,
                                                            window)
                parts.append(L.decode_attention_partial(
                    q.reshape(B, 1, Hkv, G, Dh), ck.to(q.dtype),
                    cv.to(q.dtype),
                    kv_positions=kv_pos.narrow(1, off, s_loc),
                    kv_valid=kv_valid.narrow(1, off, s_loc), q_position=lg,
                    window=window, softcap=sc))
                new.append({"k": ck, "v": cv})
            os, mxs, ls = (list(t) for t in zip(*parts))
            mx_all = col.all_gather([x[None] for x in mxs], self.mesh,
                                    "model", 0)
            o_all = col.all_gather([x[None] for x in os], self.mesh,
                                   "model", 0)
            l_all = col.all_gather([x[None] for x in ls], self.mesh,
                                   "model", 0)
            for i, (q, mx, o, l) in enumerate(zip(q_full, mx_all, o_all,
                                                  l_all)):
                a = L.combine_partials(list(mx), list(o), list(l))
                B = q.shape[0]
                a = a.to(q.dtype).reshape(B, 1, H, Dh)
                attn.append(self._flat_block(a, i))
            return attn, new
        # the cache on kv heads (their own per shard) or whole on each
        for i, (q, k, v, c, lg) in enumerate(zip(q_full, kf, vf, slots,
                                                 lengths)):
            B = q.shape[0]
            kb = self._model_block(k, i, spec=cspec)
            vb = self._model_block(v, i, spec=cspec)
            ck = cache_lib.write_token(c["k"], kb, lg, window)
            cv = cache_lib.write_token(c["v"], vb, lg, window)
            kv_pos, kv_valid = cache_lib.slot_positions(lg + 1, ck.shape[1],
                                                        window)
            hq = self._model_block(q, i, spec=(None, None, cspec[2]))
            a = L.decode_attention(
                hq.reshape(B, 1, ck.shape[2], G, Dh), ck.to(q.dtype),
                cv.to(q.dtype), kv_positions=kv_pos, kv_valid=kv_valid,
                q_position=lg, window=window, softcap=sc)
            attn.append(self._flat_block(a, i) if cspec[2] is None
                        else a.reshape(B, 1, -1))
            new.append({"k": ck, "v": cv})
        return attn, new


    def _heads_attn(self, qs, ks, vs, local_kv, window):
        """``heads`` mode: each shard its block of q heads over every row
        (its kv heads, or every kv head repeated to its q heads)."""
        cfg = self.cfg
        G = cfg.n_heads // cfg.n_kv_heads
        Dh = cfg.resolved_head_dim
        attn = []
        for i, (q, k, v) in enumerate(zip(qs, ks, vs)):
            B, S = q.shape[:2]
            if local_kv:
                q5 = q.reshape(B, S, k.shape[2], G, Dh)
            else:
                # every q head its own copy of its kv head
                k = self._heads_block(torch.repeat_interleave(k, G, 2), i)
                v = self._heads_block(torch.repeat_interleave(v, G, 2), i)
                q5 = q.reshape(B, S, k.shape[2], 1, Dh)
            attn.append(L.blockwise_attention(
                q5, k, v, window=window, softcap=cfg.attn_logit_softcap))
        return attn

    def _whole_attn(self, q_cols, qn, pos, kv_full, window):
        """``heads`` mode where the heads do not divide (the reference's
        constraint falls back to the batch): every shard every head over
        every row, from the q columns gathered whole, then its own
        ``heads_flat`` columns."""
        cfg = self.cfg
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        q_full = col.all_gather(q_cols, self.mesh, "model", 2)
        attn = []
        for i, (q, w, q_pos, k, v) in enumerate(zip(q_full, qn, pos,
                                                    *kv_full)):
            q = L.heads_of(q, w, cfg, q_pos)
            B, S = q.shape[:2]
            a = L.blockwise_attention(
                q.reshape(B, S, Hkv, -1, Dh), k, v, window=window,
                softcap=cfg.attn_logit_softcap)
            attn.append(self._flat_block(a, i))
        return attn

    def _ctx_attn(self, q_cols, qn, pos, kv_full, window):
        """``ctx`` mode (the reference's context-parallel q chunks): the q
        projection's column blocks go to row blocks by an ``all_to_all``,
        so shard j holds every head over its rows
        (:meth:`_ctx_rows`); one flash launch a shard at ``q_offset`` = its
        first row against every key (a shard with no rows launches
        nothing); the output goes back to column blocks for the
        row-parallel ``wo``."""
        cfg = self.cfg
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        S = q_cols[0].shape[1]
        chunks = self._ctx_rows(S)
        q_rows = col.all_to_all(q_cols, self.mesh, "model", 1, 2,
                                [r for _, r in chunks])
        outs = []
        for i, (q, w, q_pos, k, v) in enumerate(zip(q_rows, qn, pos,
                                                    *kv_full)):
            r0, rows = chunks[self.mesh.axis_index(i, "model")]
            B = q.shape[0]
            if rows == 0:
                outs.append(q.new_zeros((B, 0, H * Dh)))
                continue
            q = L.heads_of(q, w, cfg, q_pos[:, r0:r0 + rows])
            a = L.blockwise_attention(
                q.reshape(B, rows, Hkv, H // Hkv, Dh), k, v, window=window,
                softcap=cfg.attn_logit_softcap, q_offset=r0)
            outs.append(a.reshape(B, rows, H * Dh))
        return col.all_to_all(outs, self.mesh, "model", 2, 1)

    def _ffn_block(self, ps, xs, split, sp):
        """The dense MLP or the MoE FFN. Returns (xs, auxes): the MoE aux
        loss per shard (None for the MLP), which only training adds in,
        as the reference's serving path drops it."""
        cfg = self.cfg
        spec = self._any_ffn_spec()
        norm = self._full(self._leaf(ps, "norm"), spec["norm"])
        hs = [L.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, norm)]
        hs = self._enter(hs, sp)
        auxes = [None] * len(xs)
        if cfg.moe is not None:
            outs, auxes = self._moe(ps, hs, spec, split)
            outs = self._rows(outs, sp)
        else:
            local = not self._split or (
                spec["w_gate"] == _COL and spec["w_up"] == _COL
                and spec["w_down"] == _ROW)
            if not local:
                ps = self._whole(ps, spec, ("w_gate", "w_up", "w_down"))
            outs = [L.mlp_apply(p, h) for p, h in zip(ps, hs)]
            outs = self._exit(outs, sp) if local else self._rows(outs, sp)
        if cfg.post_norms and "post_norm" in ps[0]:
            pn = self._full(self._leaf(ps, "post_norm"), spec["post_norm"])
            outs = [L.rms_norm(o, w, cfg.norm_eps) for o, w in zip(outs, pn)]
        return [x + o for x, o in zip(xs, outs)], auxes

    def _any_ffn_spec(self):
        for spec in self._layer_spec.values():
            if "ffn" in spec:
                return spec["ffn"]

    def _whole(self, ps, spec, keys):
        """``ps`` with the leaves ``keys`` gathered whole."""
        out = [dict(p) for p in ps]
        for k in keys:
            for o, w in zip(out, self._full(self._leaf(ps, k), spec[k])):
                o[k] = w
        return out

    def _moe(self, ps, hs, spec, split):
        cfg = self.cfg
        m = self.msize
        if self._split and self.perf.shard_experts and \
                cfg.moe.n_experts % m == 0:
            assert spec["w_gate"][0] == "model", spec
            ps = self._whole(ps, spec, ("router",))
            return moe_shards(ps, hs, cfg, self.mesh, self.dp,
                              counts=self.moe_counts)
        # the dense path over the whole batch, as the reference's GSPMD
        # program runs it: the data blocks gathered, each shard's taken
        ps = self._whole(ps, spec, ("router", "w_gate", "w_up", "w_down"))
        split = split and shd.axis_size(self.mesh, self.dp) > 1
        xs = col.all_gather(hs, self.mesh, self.dp, 0) if split else hs
        outs, auxes = [], []
        for i, (p, x, h) in enumerate(zip(ps, xs, hs)):
            counts = self.moe_counts if i == 0 else None
            out, aux = moe_apply(p, x, cfg, counts=counts)
            if split:
                out = out.narrow(0, self.mesh.axis_index(i, self.dp)
                                 * h.shape[0], h.shape[0])
            outs.append(out)
            auxes.append(aux)
        return outs, auxes

    def _rglru_block(self, ps, xs, mode, slots, sp):
        cfg = self.cfg
        spec = self._layer_spec[RGLRU]["rglru"]
        norm = self._full(self._leaf(ps, "norm"), spec["norm"])
        hs = [L.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, norm)]
        hs = self._enter(hs, sp)
        wide = ("w_x", "w_gate_branch", "conv_w", "conv_b", "w_a", "b_a",
                "w_i", "b_i", "lam", "w_out")
        local = not self._split or (
            spec["w_x"] == _COL and spec["w_out"] == _ROW)
        if not local:
            ps = self._whole(ps, spec, wide)
        outs, new = [], []
        for i, (p, h) in enumerate(zip(ps, hs)):
            if mode == "decode":
                out, (conv, hstate) = rglru_step(p, h, cfg, slots[i]["conv"],
                                                 slots[i]["h"])
            elif mode == "prefill":
                out, (conv, hstate) = rglru_apply(p, h, cfg,
                                                  return_state=True)
            else:
                out, conv = rglru_apply(p, h, cfg)[0], None
            outs.append(out)
            new.append(None if conv is None else {"conv": conv, "h": hstate})
        outs = self._exit(outs, sp) if local else self._rows(outs, sp)
        return [x + o for x, o in zip(xs, outs)], new

    _RWKV_TM = ("w_r", "w_k", "w_v", "w_g", "w_o", "decay_base", "decay_B",
                "bonus_u", "ln_out")
    _RWKV_CM = ("cm_k", "cm_v", "cm_r")

    def _rwkv_block(self, ps, xs, mode, slots, sp):
        """The RWKV-6 block. On a mesh the time-mix runs on each shard's
        block of whole heads (its ``heads_flat`` columns, its ``wkv``
        state; the group norm, over all of d_model as the reference's, on
        the wkv gathered whole) with a row-parallel ``w_o``, where the
        heads divide ``model``; the channel-mix's ``cm_k`` is column-parallel on
        ``d_ff`` and ``cm_v`` row-parallel, and the value is
        reduce-scattered on ``d_model`` so each shard gates it with its
        own ``cm_r`` columns, then all-gathered (the exchange of one
        ``psum``; ``cm_r`` is never gathered). Leaves the block needs
        whole (norms, ``mu``, ``decay_A``, or the time-mix's where the
        heads do not divide) are gathered."""
        cfg = self.cfg
        spec = self._layer_spec[RWKV]["rwkv"]
        m = self.msize
        n_heads = cfg.d_model // cfg.rwkv_head_dim
        tm_local = self._split and n_heads % m == 0 and all(
            spec[k][-1] == "model" for k in self._RWKV_TM if k != "w_o") \
            and spec["w_o"] == _ROW
        cm_local = self._split and spec["cm_k"] == _COL and \
            spec["cm_v"] == _ROW and spec["cm_r"] == _COL
        whole = [k for k in spec if not (
            (tm_local and k in self._RWKV_TM)
            or (cm_local and k in self._RWKV_CM))]
        ps = self._whole(ps, spec, whole) if self._split else ps
        hs = [L.rms_norm(x, p["norm"], cfg.norm_eps) for p, x in zip(ps, xs)]
        hs = self._enter(hs, sp)
        parts = [time_mix_step_wkv(p, h, cfg, {"shift": slot["shift"],
                                               "wkv": slot["wkv"]})
                 if mode == "decode" else
                 time_mix_wkv(p, h, cfg, None, chunk=self.rwkv_chunk)
                 for p, h, slot in zip(ps, hs, slots)]
        wkvs, gs, states = (list(t) for t in zip(*parts))
        if tm_local:
            # the group norm spans every channel: wkv and ln_out whole,
            # then each shard its columns
            wkvs = col.all_gather(wkvs, self.mesh, "model", 2)
            ln = self._full(self._leaf(ps, "ln_out"), spec["ln_out"])
            outs = [time_mix_out(p, w, g, h, cfg, ln_out=lw,
                                 cols=lambda t, i=i: self._flat_block(t, i))
                    for i, (p, w, g, h, lw) in enumerate(
                        zip(ps, wkvs, gs, hs, ln))]
            outs = self._exit(outs, sp)
        else:
            outs = self._rows([time_mix_out(p, w, g, h, cfg) for p, w, g, h
                               in zip(ps, wkvs, gs, hs)], sp)
        xs = [x + o for x, o in zip(xs, outs)]
        h2s = [L.rms_norm(x, p["cm_norm"], cfg.norm_eps)
               for p, x in zip(ps, xs)]
        h2s = self._enter(h2s, sp)
        mixed = [cm_mix(p, h2, slot["cm_shift"] if mode == "decode"
                        else None) for p, h2, slot in zip(ps, h2s, slots)]
        gates = [cm_gate(p, xr) for p, (_, xr) in zip(ps, mixed)]
        vals = [cm_key(p, xk) for p, (xk, _) in zip(ps, mixed)]
        if cm_local:
            vals = col.reduce_scatter(vals, self.mesh, "model", 2)
            outs = col.all_gather([g * v for g, v in zip(gates, vals)],
                                  self.mesh, "model", 2)
        else:
            outs = [g * v for g, v in zip(gates, vals)]
        xs = [x + o for x, o in zip(xs, self._rows(outs, sp))]
        if mode == "train":
            return xs, [None] * len(xs)
        return xs, [{"shift": h[:, -1], "wkv": st, "cm_shift": h2[:, -1]}
                    for h, st, h2 in zip(hs, states, h2s)]

    def _layer(self, kind, layers, xs, pos, mode, slots, lengths, split,
               sp=False, max_seq=None):
        """One layer over the shards: (xs, its new caches (None in train
        mode), its MoE aux losses or Nones). ``split``: the batch is split
        over the data axes; ``sp``: the residual stream over S;
        ``max_seq``: the decode cache's size."""
        n = len(xs)
        slots = [None] * n if slots is None else slots
        if kind == RWKV:
            xs, nc = self._rwkv_block([p["rwkv"] for p in layers], xs, mode,
                                      slots, sp)
            return xs, nc, [None] * n
        if kind == RGLRU:
            xs, nc = self._rglru_block([p["rglru"] for p in layers], xs,
                                       mode, slots, sp)
        else:
            xs, nc = self._attn_block([p["attn"] for p in layers], xs, kind,
                                      pos, mode, slots, lengths, sp, max_seq)
        xs, auxes = self._ffn_block([p["ffn"] for p in layers], xs, split,
                                    sp)
        return xs, nc, auxes

    def _train_group(self, kinds, n, *args, treedef, split, sp=False):
        """One pattern group in train mode over ``n`` shards: args are
        the shards' x, then their positions, then the group's params
        flattened (one list of layers per shard). Returns the shards' x
        then their aux sums (each from a float32 zero in slot order, as
        the reference's group_fn)."""
        xs, pos = list(args[:n]), list(args[n:2 * n])
        groups = tr.unflatten(treedef, list(args[2 * n:]))
        if self.gather_group is not None:
            groups = self.gather_group(groups)
        aux_g = [torch.zeros((), dtype=torch.float32, device=x.device)
                 for x in xs]
        for j, kind in enumerate(kinds):
            xs, _, auxes = self._layer(kind, [g[j] for g in groups], xs, pos,
                                       "train", None, None, split, sp)
            aux_g = [a if b is None else a + b for a, b in zip(aux_g, auxes)]
        return (*xs, *aux_g)

    def _remat(self, fn, *args):
        if self.remat_policy == "none":
            return fn(*args)
        if self.remat_policy == "dots":
            return ckpt.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    _dots_policy))
        return ckpt.checkpoint(fn, *args, use_reentrant=False)

    def _backbone(self, ps, xs, pos, mode, caches=None, lengths=None, *,
                  split: bool = True, max_seq=None):
        """The layers over the shards. ``ps``: one tree of the
        :meth:`params` layout per shard (its ``embed`` already in the
        compute layout). ``caches``: per shard, per layer, the slot cache
        (decode) or, for an attention layer at prefill, the cache size to
        fill (None in train mode). Returns (xs, per shard the new
        per-layer caches (None in train mode), per shard the MoE aux loss
        summed over layers (train mode; None otherwise)). Under
        ``seq_parallel`` (:meth:`_seq_split`) the residual stream runs on
        each shard's rows from the embedding to the final norm, and comes
        back whole."""
        n = len(xs)
        sp = self._seq_split(xs[0].shape[1], mode)
        xs = self._rows(xs, sp)
        kinds = self.cfg.layer_kinds
        layers = [p["layers"] for p in ps]
        aux_total = None
        new = None
        if mode == "train":
            aux_total = [torch.zeros((), dtype=torch.float32,
                                     device=x.device) for x in xs]
            n_pat = len(self.cfg.layer_pattern)
            n_grouped = self.cfg.n_groups * n_pat
            for g in range(0, n_grouped, n_pat):
                flat, treedef = tr.flatten([lay[g:g + n_pat]
                                            for lay in layers])
                fn = functools.partial(self._train_group, kinds[g:g + n_pat],
                                       n, treedef=treedef, split=split,
                                       sp=sp)
                out = self._remat(fn, *xs, *pos, *flat)
                xs = list(out[:n])
                aux_total = [a + b for a, b in zip(aux_total, out[n:])]
            tail = [lay[n_grouped:] for lay in layers]
            if tail[0] and self.gather_tail is not None:
                tail = self.gather_tail(tail)
            for j, kind in enumerate(kinds[n_grouped:]):
                xs, _, auxes = self._layer(kind, [t[j] for t in tail], xs,
                                           pos, mode, None, None, split, sp)
                aux_total = [a if b is None else a + b
                             for a, b in zip(aux_total, auxes)]
        else:
            new = [[] for _ in range(n)]
            for j, kind in enumerate(kinds):
                xs, nc, _ = self._layer(kind, [lay[j] for lay in layers], xs,
                                        pos, mode, [c[j] for c in caches],
                                        lengths, split, sp, max_seq)
                for c, x in zip(new, nc):
                    c.append(x)
        fn_spec = self._embed_spec["final_norm"]
        fnorm = self._full([p["embed"]["final_norm"] for p in ps], fn_spec)
        xs = [L.rms_norm(x, w, self.cfg.norm_eps) for x, w in zip(xs, fnorm)]
        return self._enter(xs, sp), new, aux_total

    def backbone(self, x, positions, mode, caches=None, lengths=None,
                 params=None):
        """The unsharded form: x (B, S, d). ``caches``: per layer, the
        slot cache (decode) or, for an attention layer at prefill, the
        cache size to fill (None in train mode). ``params``: a tree of the
        :meth:`params` layout, or None for the module's own. Returns (x,
        new per-layer caches (None in train mode), the MoE aux loss summed
        over layers (train mode; None otherwise))."""
        tree = self.params() if params is None else params
        xs, new, aux = self._backbone(
            [tree], [x], [positions], mode,
            None if caches is None else [caches],
            None if lengths is None else [lengths])
        return xs[0], None if new is None else new[0], \
            None if aux is None else aux[0]

    # -------------------------------------------------------- embedding
    def _embed_tokens(self, es, tokens):
        cfg = self.cfg
        spec = self._embed_spec["table"]
        tables = self._leaf(es, "table")
        if not self._split or spec == (None, None):
            return [L.embed_tokens({"table": t}, tok, cfg)
                    for t, tok in zip(tables, tokens)]
        if spec == _ROW:
            # vocab-parallel: each shard its rows, zero elsewhere; the sum
            # has one nonzero term, so it is the row itself
            parts = []
            for i, (t, tok) in enumerate(zip(tables, tokens)):
                V = t.shape[0]
                lt = tok.long() - self.mesh.axis_index(i, "model") * V
                mine = (lt >= 0) & (lt < V)
                rows = t[lt.clamp(0, V - 1)]
                parts.append(torch.where(mine[..., None], rows,
                                         torch.zeros_like(rows)))
            xs = self._psum(parts)
        else:
            xs = col.all_gather([t[tok.long()] for t, tok in
                                 zip(tables, tokens)], self.mesh, "model",
                                -1)
        xs = [x.to(L.dtype_of(cfg.dtype)) for x in xs]
        if cfg.tie_embeddings:
            xs = [L.scale_by(x, math.sqrt(cfg.d_model)) for x in xs]
        return xs

    def _embed_inputs(self, inputs, es, start_positions=None):
        """``frames`` (B, S, d) for the ``embeddings`` frontend; ``tokens``
        (B, S) otherwise, with ``patches`` (B, P, d) before them for
        ``vlm`` when given (decode steps carry tokens only); per shard."""
        cfg = self.cfg
        if cfg.frontend == "embeddings":
            xs = [b["frames"].to(L.dtype_of(cfg.dtype)) for b in inputs]
        else:
            xs = self._embed_tokens(es, [b["tokens"] for b in inputs])
            if cfg.frontend == "vlm":
                xs = [torch.cat([b["patches"].to(x.dtype), x], dim=1)
                      if "patches" in b else x for b, x in zip(inputs, xs)]
        pos = []
        for i, x in enumerate(xs):
            B, S = x.shape[:2]
            p = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
            if start_positions is not None:
                p = p + start_positions[i][:, None]
            pos.append(p.expand(B, S))
        return xs, pos

    def _embed_params(self, ps):
        es = [p["embed"] for p in ps]
        if self.gather_embed is not None:
            es = self.gather_embed(es)
        return es

    def _head(self, es):
        """The head's weights per shard and whether they are the shards'
        vocab blocks (else whole)."""
        key = "head" if "head" in es[0] else "table"
        spec = self._embed_spec[key]
        ws = [L.head_weight(e) for e in es]
        vocab = spec == (_COL if key == "head" else _ROW)
        if not self._split or vocab:
            return ws, self._split
        tspec = spec if key == "head" else spec[::-1]
        return self._full(ws, tspec), False

    def _logits(self, es, xs):
        ws, vocab = self._head(es)
        out = [L.head_logits(w, x, self.cfg) for w, x in zip(ws, xs)]
        if vocab:
            out = col.all_gather(out, self.mesh, "model", -1)
        return out

    def _ce(self, es, xs, ts, chunk: int = 256):
        """Per shard, the (total, count) of the chunked cross entropy over
        its batch block (summed over the vocab shards where the head is
        vocab-parallel)."""
        ws, vocab = self._head(es)
        cfg = self.cfg
        if not vocab:
            return [L.ce_sums(w, x, t, cfg, chunk) for w, x, t in
                    zip(ws, xs, ts)]
        S = xs[0].shape[1]
        chunk = min(chunk, S)
        tots = [torch.zeros((), dtype=torch.float32, device=x.device)
                for x in xs]
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            parts = [ckpt.checkpoint(
                L.ce_chunk_local, x[:, sl], t[:, sl], w,
                self.mesh.axis_index(i, "model") * w.shape[1],
                cfg.final_logit_softcap, use_reentrant=False)
                for i, (x, t, w) in enumerate(zip(xs, ts, ws))]
            lses, picks = (list(z) for z in zip(*parts))
            allm = col.all_gather([a[None] for a in lses], self.mesh,
                                  "model", 0)
            M = [a.max(dim=0).values.detach() for a in allm]
            ex = self._psum([torch.exp(a - mx) for a, mx in zip(lses, M)])
            picked = self._psum(picks)
            tots = [tot + (mx + torch.log(e) - pk).sum()
                    for tot, mx, e, pk in zip(tots, M, ex, picked)]
        return [(tot, torch.full((), float(x.shape[0] * S),
                                 device=x.device)) for tot, x in
                zip(tots, xs)]

    def _shards(self, tree_s):
        """``(trees, sharded)``: the per-shard list of a tuple of trees,
        or a one-element list of a bare tree (a one-shard mesh only)."""
        n = self.mesh.size
        if not isinstance(tree_s, tuple):
            if n != 1:
                raise ValueError(f"a mesh of {n} shards takes a tuple of "
                                 f"{n} trees")
            return [tree_s], False
        if len(tree_s) != n:
            raise ValueError(f"{len(tree_s)} trees for a mesh of {n} "
                             "shards")
        return list(tree_s), True

    # ------------------------------------------------------------- train
    def loss(self, batch, params=None, *, split: bool = True):
        """The reference's train loss on ``batch`` (``tokens`` or
        ``frames``, ``vlm``'s ``patches``, and ``targets`` (B, S_text)):
        the backbone in train mode, only the text positions for ``vlm``,
        predict position t+1 from t, chunked cross entropy, plus the MoE
        aux loss. ``params``: a tree of the :meth:`params` layout (None:
        the module's own). On a mesh, ``batch`` and ``params`` are tuples
        of per-shard trees and the values are the global ones, on the
        first shard's device; ``split``: the class docstring. Returns
        (loss, {"ce", "aux"}), float32 scalars."""
        cfg = self.cfg
        bs, sharded = self._shards(batch)
        if params is None:
            ps = list(self.shard_params()) if sharded else [self.params()]
        else:
            ps = self._shards(params)[0]
        es = self._embed_params(ps)
        xs, pos = self._embed_inputs(bs, es)
        ps = [dict(p, embed=e) for p, e in zip(ps, es)]
        xs, _, auxes = self._backbone(ps, xs, pos, "train", split=split)
        if cfg.frontend == "vlm":
            xs = [x[:, cfg.n_patches:] for x in xs]
        xs = [x[:, :-1] for x in xs]
        ts = [b["targets"][:, 1:] for b in bs]
        sums = self._ce(es, xs, ts)
        tot = self._data_sum([s[0] for s in sums], split)
        cnt = self._data_sum([s[1] for s in sums], split)
        ce = tot[0] / torch.clamp(cnt[0], min=1.0)
        aux = auxes[0]
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, inputs, max_seq=None, params=None, *,
                split: bool = True):
        """inputs: {"tokens": (B, S) int32} (``vlm``: also {"patches":
        (B, P, d)}, placed first; ``embeddings``: {"frames": (B, S, d)}).
        ``max_seq`` sizes the cache (>= prompt + planned generation;
        default the prompt length). Returns (last-position logits (B, V)
        float32, cache); on a mesh, tuples of the shards' (logits over
        their batch block, cache in :meth:`cache_specs`' layout)."""
        bs, sharded = self._shards(inputs)
        ps = self._serve_params(params, sharded)
        es = [p["embed"] for p in ps]
        xs, pos = self._embed_inputs(bs, es)
        caches = []
        for x in xs:
            B, S = x.shape[:2]
            size = max_seq or S
            caches.append([d["k"].shape[1] if "k" in d else None
                           for d in self.cache_defs(B, size)["layers"]])
        xs, layers, _ = self._backbone(ps, xs, pos, "prefill", caches, None,
                                       split=split)
        logits = self._logits(es, [x[:, -1:] for x in xs])
        out = []
        for lg, x, lay in zip(logits, xs, layers):
            B, S = x.shape[:2]
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
            out.append((lg[:, 0], {"lengths": lengths, "layers": lay}))
        if not sharded:
            return out[0]
        return tuple(o[0] for o in out), tuple(o[1] for o in out)

    @torch.no_grad()
    def decode_step(self, inputs, cache, params=None, *,
                    split: bool = True, max_seq=None):
        """inputs: {"tokens": (B, 1) int32} ({"frames": (B, 1, d)} for
        ``embeddings``). Returns (logits (B, V) float32, the cache advanced
        by one token per sample); on a mesh, tuples of the shards'.
        ``max_seq``: the cache's size (:meth:`cache_specs`'), which a mesh
        with ``model`` > 1 needs to read its blocks' layout
        (``launch.steps.build_decode_step`` passes it)."""
        if self._split and max_seq is None:
            raise ValueError("decode_step on a mesh with model > 1 needs "
                             "max_seq, the cache's size")
        bs, sharded = self._shards(inputs)
        cs = self._shards(cache)[0]
        ps = self._serve_params(params, sharded)
        es = [p["embed"] for p in ps]
        lengths = [c["lengths"] for c in cs]
        xs, pos = self._embed_inputs(bs, es, start_positions=lengths)
        xs, layers, _ = self._backbone(ps, xs, pos, "decode",
                                       [c["layers"] for c in cs], lengths,
                                       split=split, max_seq=max_seq)
        logits = self._logits(es, xs)
        out = [(lg[:, 0], {"lengths": ln + 1, "layers": lay})
               for lg, ln, lay in zip(logits, lengths, layers)]
        if not sharded:
            return out[0]
        return tuple(o[0] for o in out), tuple(o[1] for o in out)

    def _serve_params(self, params, sharded):
        if params is not None:
            return self._shards(params)[0]
        return list(self.shard_params()) if sharded else [self.params()]


def _check_params(d, p, path: str = "") -> None:
    """The given weights must have exactly the defs' structure, shapes and
    dtypes."""
    if P.is_def(d):
        if tuple(p.shape) != d.shape or p.dtype != d.dtype:
            raise ValueError(f"params{path}: {tuple(p.shape)} {p.dtype}, "
                             f"expected {d.shape} {d.dtype}")
    elif isinstance(d, dict):
        if set(d) != set(p):
            raise ValueError(f"params{path}: keys {sorted(p)}, expected "
                             f"{sorted(d)}")
        for k in d:
            _check_params(d[k], p[k], f"{path}[{k!r}]")
    else:
        if len(d) != len(p):
            raise ValueError(f"params{path}: {len(p)} entries, expected "
                             f"{len(d)}")
        for i, (a, b) in enumerate(zip(d, p)):
            _check_params(a, b, f"{path}[{i}]")
