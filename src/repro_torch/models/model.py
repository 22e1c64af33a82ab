"""The LM serving path — port of ``repro.models.model``.

``LM`` is an ``nn.Module`` holding its weights; the config's
``layer_pattern`` picks each layer's block. Two entry points, the
reference's serving pair:
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
other). Sharding hooks are not carried over.

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
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV,
                                      ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.rglru import rglru_apply, rglru_defs, rglru_step
from repro_torch.models.rwkv6 import (channel_mix, rwkv_defs, time_mix,
                                      time_mix_step)
from repro_torch.train import tree as tr

_FRONTENDS = ("none", "embeddings", "vlm")


def _check_config(cfg: ModelConfig) -> None:
    for kind in set(cfg.layer_kinds):
        if kind not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV):
            raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


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


class LM(nn.Module):
    """A decoder-only LM over ``cfg`` on ``device`` (``None`` = CUDA).

    Weights come from ``params`` (the port layout, e.g. from
    ``convert.lm_params_from_numpy``) or, without it, are drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``. ``rwkv_chunk``
    > 1 runs the RWKV wkv chunkwise at prefill (0: the exact sequential
    recurrence), as the reference's constructor. ``moe_counts``, when set
    to a list, receives each MoE call's (dropped, total) assignment counts
    as device tensors. ``remat_policy`` (``none | dots | full``) is the
    train mode's checkpointing.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, params=None,
                 seed: int = 0, rwkv_chunk: int = 0,
                 remat_policy: str = "full"):
        super().__init__()
        _check_config(cfg)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        self.cfg = cfg
        self.rwkv_chunk = rwkv_chunk
        self.remat_policy = remat_policy
        self.moe_counts = None
        self.device = resolve_device(device)
        defs = self.param_defs()
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
        :meth:`params` layout, same shapes and dtypes; no copy). A train
        loop calls it after each step, so the module serves the trained
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

    # ------------------------------------------------------------- cache
    def _window(self, kind: str) -> int:
        return self.cfg.local_window if kind == ATTN_LOCAL else 0

    def _layer_cache_defs(self, kind: str, batch: int, max_seq: int):
        if kind == RGLRU:
            return cache_lib.rglru_cache_defs(self.cfg, batch)
        if kind == RWKV:
            return cache_lib.rwkv_cache_defs(self.cfg, batch)
        return cache_lib.kv_cache_defs(self.cfg, batch, max_seq,
                                       window=self._window(kind))

    def cache_defs(self, batch: int, max_seq: int) -> dict:
        return {
            "lengths": P.ParamDef((batch,), ("batch",), torch.int32,
                                  "zeros"),
            "layers": [self._layer_cache_defs(k, batch, max_seq)
                       for k in self.cfg.layer_kinds],
        }

    def init_cache(self, batch: int, max_seq: int) -> dict:
        return P.init(self.cache_defs(batch, max_seq), None, self.device)

    # ------------------------------------------------------------ blocks
    def _attn_block(self, p, x, kind, positions, mode, slot, lengths):
        """``slot``: the layer's cache (decode) or its size (prefill)."""
        cfg = self.cfg
        window = self._window(kind)
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        G = H // Hkv
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        if mode == "decode":
            q, k, v = L.attention_qkv(p, h, cfg, lengths[:, None])
            B = q.shape[0]
            ck = cache_lib.write_token(slot["k"], k, lengths, window)
            cv = cache_lib.write_token(slot["v"], v, lengths, window)
            kv_pos, kv_valid = cache_lib.slot_positions(
                lengths + 1, ck.shape[1], window)
            attn = L.decode_attention(
                q.reshape(B, 1, Hkv, G, Dh), ck.to(h.dtype), cv.to(h.dtype),
                kv_positions=kv_pos, kv_valid=kv_valid, q_position=lengths,
                window=window, softcap=cfg.attn_logit_softcap)
            new_cache = {"k": ck, "v": cv}
        else:
            q, k, v = L.attention_qkv(p, h, cfg, positions)
            B, S = q.shape[:2]
            attn = L.blockwise_attention(
                q.reshape(B, S, Hkv, G, Dh), k, v, window=window,
                softcap=cfg.attn_logit_softcap)
            new_cache = None if mode == "train" else {
                "k": cache_lib.fill_from_prefill(k, slot, window),
                "v": cache_lib.fill_from_prefill(v, slot, window)}
        out = L.attention_out(p, attn, x.dtype)
        if cfg.post_norms:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out, new_cache

    def _ffn_block(self, p, x):
        """The dense MLP or the MoE FFN. Returns (x, aux): the MoE aux loss
        (None for the MLP), which only training adds in, as the reference's
        serving path drops it."""
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        aux = None
        if cfg.moe is not None:
            out, aux = moe_apply(p, h, cfg, counts=self.moe_counts)
        else:
            out = L.mlp_apply(p, h)
        if cfg.post_norms and "post_norm" in p:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out, aux

    def _rglru_block(self, p, x, mode, slot):
        h = L.rms_norm(x, p["norm"], self.cfg.norm_eps)
        if mode == "decode":
            out, (conv, hstate) = rglru_step(p, h, self.cfg, slot["conv"],
                                             slot["h"])
        elif mode == "prefill":
            out, (conv, hstate) = rglru_apply(p, h, self.cfg,
                                              return_state=True)
        else:
            return x + rglru_apply(p, h, self.cfg)[0], None
        return x + out, {"conv": conv, "h": hstate}

    def _rwkv_block(self, p, x, mode, slot):
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        if mode == "decode":
            out, tm = time_mix_step(p, h, cfg, {"shift": slot["shift"],
                                                "wkv": slot["wkv"]})
            cm_state = slot["cm_shift"]
        else:
            out, tm = time_mix(p, h, cfg, None, chunk=self.rwkv_chunk,
                               return_state=mode == "prefill")
            cm_state = None
        x = x + out
        h2 = L.rms_norm(x, p["cm_norm"], cfg.norm_eps)
        if mode == "train":
            return x + channel_mix(p, h2, cfg, None)[0], None
        out2, cm = channel_mix(p, h2, cfg, cm_state, return_state=True)
        return x + out2, {"shift": tm["shift"], "wkv": tm["wkv"],
                          "cm_shift": cm}

    def _layer(self, kind, layer, x, positions, mode, c, lengths):
        """One layer: (x, its new cache (None in train mode), its MoE aux
        loss or None)."""
        if kind == RWKV:
            x, nc = self._rwkv_block(layer["rwkv"], x, mode, c)
            return x, nc, None
        if kind == RGLRU:
            x, nc = self._rglru_block(layer["rglru"], x, mode, c)
        else:
            x, nc = self._attn_block(layer["attn"], x, kind, positions,
                                     mode, c, lengths)
        x, aux = self._ffn_block(layer["ffn"], x)
        return x, nc, aux

    def _train_group(self, kinds, x, positions, *flat, treedef):
        """One pattern group in train mode: (x, the group's aux sum, from
        a float32 zero in slot order, as the reference's group_fn)."""
        layers = tr.unflatten(treedef, list(flat))
        aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, layer in zip(kinds, layers):
            x, _, aux = self._layer(kind, layer, x, positions, "train",
                                    None, None)
            if aux is not None:
                aux_g = aux_g + aux
        return x, aux_g

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

    def backbone(self, x, positions, mode, caches=None, lengths=None,
                 params=None):
        """x: (B, S, d). ``caches``: per layer, the slot cache (decode) or,
        for an attention layer at prefill, the cache size to fill (None in
        train mode). ``params``: a tree of the :meth:`params` layout, or
        None for the module's own. Returns (x, new per-layer caches (None
        in train mode), the MoE aux loss summed over layers (train mode;
        None otherwise))."""
        tree = self.params() if params is None else params
        kinds, layers = self.cfg.layer_kinds, tree["layers"]
        aux_total = None
        if mode == "train":
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
            n_pat = len(self.cfg.layer_pattern)
            n_grouped = self.cfg.n_groups * n_pat
            for g in range(0, n_grouped, n_pat):
                flat, treedef = tr.flatten(layers[g:g + n_pat])
                fn = functools.partial(self._train_group,
                                       kinds[g:g + n_pat], treedef=treedef)
                x, aux_g = self._remat(fn, x, positions, *flat)
                aux_total = aux_total + aux_g
            for kind, layer in zip(kinds[n_grouped:], layers[n_grouped:]):
                x, _, aux = self._layer(kind, layer, x, positions, mode,
                                        None, None)
                if aux is not None:
                    aux_total = aux_total + aux
            new = None
        else:
            new = []
            for kind, layer, c in zip(kinds, layers, caches):
                x, nc, _ = self._layer(kind, layer, x, positions, mode, c,
                                       lengths)
                new.append(nc)
        x = L.rms_norm(x, tree["embed"]["final_norm"], self.cfg.norm_eps)
        return x, new, aux_total

    def _embed_inputs(self, inputs, start_positions=None, embed=None):
        """``frames`` (B, S, d) for the ``embeddings`` frontend; ``tokens``
        (B, S) otherwise, with ``patches`` (B, P, d) before them for
        ``vlm`` when given (decode steps carry tokens only)."""
        cfg = self.cfg
        if cfg.frontend == "embeddings":
            x = inputs["frames"].to(L.dtype_of(cfg.dtype))
        else:
            x = L.embed_tokens(self.embed if embed is None else embed,
                               inputs["tokens"], cfg)
            if cfg.frontend == "vlm" and "patches" in inputs:
                x = torch.cat([inputs["patches"].to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if start_positions is not None:
            pos = pos + start_positions[:, None]
        return x, pos.expand(B, S)

    # ------------------------------------------------------------- train
    def loss(self, batch, params=None):
        """The reference's train loss on ``batch`` (``tokens`` or
        ``frames``, ``vlm``'s ``patches``, and ``targets`` (B, S_text)):
        the backbone in train mode, only the text positions for ``vlm``,
        predict position t+1 from t, chunked cross entropy, plus the MoE
        aux loss. ``params``: a tree of the :meth:`params` layout (None:
        the module's own). Returns (loss, {"ce", "aux"}), float32 scalars."""
        cfg = self.cfg
        tree = self.params() if params is None else params
        x, positions = self._embed_inputs(batch, embed=tree["embed"])
        x, _, aux = self.backbone(x, positions, "train", params=tree)
        if cfg.frontend == "vlm":
            x = x[:, cfg.n_patches:]
        x = x[:, :-1]
        t = batch["targets"][:, 1:]
        ce = L.chunked_cross_entropy(tree["embed"], x, t, cfg)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, inputs, max_seq=None):
        """inputs: {"tokens": (B, S) int32} (``vlm``: also {"patches":
        (B, P, d)}, placed first; ``embeddings``: {"frames": (B, S, d)}).
        ``max_seq`` sizes the cache (>= prompt + planned generation;
        default the prompt length). Returns (last-position logits (B, V)
        float32, cache)."""
        x, positions = self._embed_inputs(inputs)
        B, S = x.shape[:2]
        sizes = [d["k"].shape[1] if "k" in d else None
                 for d in self.cache_defs(B, max_seq or S)["layers"]]
        x, layers, _ = self.backbone(x, positions, "prefill", sizes, None)
        logits = L.lm_head(self.embed, x[:, -1:], self.cfg)[:, 0]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, {"lengths": lengths, "layers": layers}

    @torch.no_grad()
    def decode_step(self, inputs, cache):
        """inputs: {"tokens": (B, 1) int32} ({"frames": (B, 1, d)} for
        ``embeddings``). Returns (logits (B, V) float32, the cache advanced
        by one token per sample)."""
        lengths = cache["lengths"]
        x, positions = self._embed_inputs(inputs, start_positions=lengths)
        x, layers, _ = self.backbone(x, positions, "decode",
                                     cache["layers"], lengths)
        logits = L.lm_head(self.embed, x, self.cfg)[:, 0]
        return logits, {"lengths": lengths + 1, "layers": layers}


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
