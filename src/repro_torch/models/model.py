"""The LM serving path — port of ``repro.models.model``.

``LM`` is an ``nn.Module`` holding its weights; the config's
``layer_pattern`` picks each layer's block. Two entry points, the
reference's serving pair:
  * ``prefill(inputs, max_seq=None)`` — the whole prompt at once, one
    flash-attention launch per attention layer; returns the last
    position's logits and a filled cache;
  * ``decode_step(inputs, cache)`` — one token per sample against the
    cache.
Layers are an ``nn.ModuleList`` in model order, where the reference scans
over stacked pattern groups and runs the remainder as ``tail`` layers
(``convert.lm_params_from_numpy`` maps one layout onto the other). Global
and local (ring-cache) attention with the dense SwiGLU MLP are ported; MoE,
RG-LRU and RWKV blocks and the ``embeddings``/``vlm`` frontends raise
``NotImplementedError`` until their slice. The ``loss`` entry point waits
for the training slice; sharding hooks are not carried over.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV,
                                      ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers as L
from repro_torch.models import param as P

_LATER = "not ported yet (ROADMAP.md, port queue: the MoE/RG-LRU/RWKV " \
         "blocks and the model frontends)"


def _check_ported(cfg: ModelConfig) -> None:
    for kind in set(cfg.layer_kinds):
        if kind in (RGLRU, RWKV):
            raise NotImplementedError(f"{cfg.name}: {kind} blocks are "
                                      f"{_LATER}")
        if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
            raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are {_LATER}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} "
                                  f"frontend is {_LATER}")


def _frozen(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class LM(nn.Module):
    """A decoder-only LM over ``cfg`` on ``device`` (``None`` = CUDA).

    Weights come from ``params`` (the port layout, e.g. from
    ``convert.lm_params_from_numpy``) or, without it, are drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, params=None,
                 seed: int = 0):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
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

    # ------------------------------------------------------------ params
    def param_defs(self) -> dict:
        # every ported layer kind is attention + the dense MLP
        cfg = self.cfg
        return {"embed": L.embed_defs(cfg),
                "layers": [{"attn": L.attention_defs(cfg),
                            "ffn": L.mlp_defs(cfg)}
                           for _ in cfg.layer_kinds]}

    def param_count(self) -> int:
        return P.count(self.param_defs())

    def param_bytes(self) -> int:
        return P.bytes_of(self.param_defs())

    # ------------------------------------------------------------- cache
    def _window(self, kind: str) -> int:
        return self.cfg.local_window if kind == ATTN_LOCAL else 0

    def cache_defs(self, batch: int, max_seq: int) -> dict:
        return {
            "lengths": P.ParamDef((batch,), ("batch",), torch.int32,
                                  "zeros"),
            "layers": [cache_lib.kv_cache_defs(self.cfg, batch, max_seq,
                                               window=self._window(k))
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
            new_cache = {"k": cache_lib.fill_from_prefill(k, slot, window),
                         "v": cache_lib.fill_from_prefill(v, slot, window)}
        out = L.attention_out(p, attn, x.dtype)
        if cfg.post_norms:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out, new_cache

    def _ffn_block(self, p, x):
        cfg = self.cfg
        out = L.mlp_apply(p, L.rms_norm(x, p["norm"], cfg.norm_eps))
        if cfg.post_norms and "post_norm" in p:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out

    def backbone(self, x, positions, mode, caches, lengths):
        """x: (B, S, d). ``caches``: per layer, the slot cache (decode) or
        the cache size to fill (prefill). Returns (x, new per-layer caches)."""
        new = []
        for kind, layer, c in zip(self.cfg.layer_kinds, self.layers, caches):
            x, nc = self._attn_block(layer["attn"], x, kind, positions, mode,
                                     c, lengths)
            x = self._ffn_block(layer["ffn"], x)
            new.append(nc)
        return L.rms_norm(x, self.embed["final_norm"], self.cfg.norm_eps), new

    def _embed_inputs(self, inputs, start_positions=None):
        tokens = inputs["tokens"]
        x = L.embed_tokens(self.embed, tokens, self.cfg)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if start_positions is not None:
            pos = pos + start_positions[:, None]
        return x, pos.expand(B, S)

    # ------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, inputs, max_seq=None):
        """inputs: {"tokens": (B, S) int32}. ``max_seq`` sizes the cache
        (>= prompt + planned generation; default the prompt length).
        Returns (last-position logits (B, V) float32, cache)."""
        x, positions = self._embed_inputs(inputs)
        B, S = x.shape[:2]
        sizes = [d["k"].shape[1]
                 for d in self.cache_defs(B, max_seq or S)["layers"]]
        x, layers = self.backbone(x, positions, "prefill", sizes, None)
        logits = L.lm_head(self.embed, x[:, -1:], self.cfg)[:, 0]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, {"lengths": lengths, "layers": layers}

    @torch.no_grad()
    def decode_step(self, inputs, cache):
        """inputs: {"tokens": (B, 1) int32}. Returns (logits (B, V) float32,
        the cache advanced by one token per sample)."""
        lengths = cache["lengths"]
        x, positions = self._embed_inputs(inputs, start_positions=lengths)
        x, layers = self.backbone(x, positions, "decode", cache["layers"],
                                  lengths)
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
