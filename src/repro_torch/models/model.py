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
other). The ``loss`` entry point waits for the training slice; sharding
hooks are not carried over.
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
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.rglru import rglru_apply, rglru_defs, rglru_step
from repro_torch.models.rwkv6 import (channel_mix, rwkv_defs, time_mix,
                                      time_mix_step)

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
    as device tensors.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, params=None,
                 seed: int = 0, rwkv_chunk: int = 0):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.rwkv_chunk = rwkv_chunk
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
            new_cache = {"k": cache_lib.fill_from_prefill(k, slot, window),
                         "v": cache_lib.fill_from_prefill(v, slot, window)}
        out = L.attention_out(p, attn, x.dtype)
        if cfg.post_norms:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out, new_cache

    def _ffn_block(self, p, x):
        """The dense MLP or the MoE FFN (whose aux loss serving drops, as
        the reference's serving path does)."""
        cfg = self.cfg
        h = L.rms_norm(x, p["norm"], cfg.norm_eps)
        if cfg.moe is not None:
            out, _ = moe_apply(p, h, cfg, counts=self.moe_counts)
        else:
            out = L.mlp_apply(p, h)
        if cfg.post_norms and "post_norm" in p:
            out = L.rms_norm(out, p["post_norm"], cfg.norm_eps)
        return x + out

    def _rglru_block(self, p, x, mode, slot):
        h = L.rms_norm(x, p["norm"], self.cfg.norm_eps)
        if mode == "decode":
            out, (conv, hstate) = rglru_step(p, h, self.cfg, slot["conv"],
                                             slot["h"])
        else:
            out, (conv, hstate) = rglru_apply(p, h, self.cfg,
                                              return_state=True)
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
                               return_state=True)
            cm_state = None
        x = x + out
        h2 = L.rms_norm(x, p["cm_norm"], cfg.norm_eps)
        out2, cm = channel_mix(p, h2, cfg, cm_state, return_state=True)
        return x + out2, {"shift": tm["shift"], "wkv": tm["wkv"],
                          "cm_shift": cm}

    def backbone(self, x, positions, mode, caches, lengths):
        """x: (B, S, d). ``caches``: per layer, the slot cache (decode) or,
        for an attention layer at prefill, the cache size to fill. Returns
        (x, new per-layer caches)."""
        new = []
        for kind, layer, c in zip(self.cfg.layer_kinds, self.layers, caches):
            if kind == RWKV:
                x, nc = self._rwkv_block(layer["rwkv"], x, mode, c)
                new.append(nc)
                continue
            if kind == RGLRU:
                x, nc = self._rglru_block(layer["rglru"], x, mode, c)
            else:
                x, nc = self._attn_block(layer["attn"], x, kind, positions,
                                         mode, c, lengths)
            x = self._ffn_block(layer["ffn"], x)
            new.append(nc)
        return L.rms_norm(x, self.embed["final_norm"], self.cfg.norm_eps), new

    def _embed_inputs(self, inputs, start_positions=None):
        """``frames`` (B, S, d) for the ``embeddings`` frontend; ``tokens``
        (B, S) otherwise, with ``patches`` (B, P, d) before them for
        ``vlm`` when given (decode steps carry tokens only)."""
        cfg = self.cfg
        if cfg.frontend == "embeddings":
            x = inputs["frames"].to(L.dtype_of(cfg.dtype))
        else:
            x = L.embed_tokens(self.embed, inputs["tokens"], cfg)
            if cfg.frontend == "vlm" and "patches" in inputs:
                x = torch.cat([inputs["patches"].to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if start_positions is not None:
            pos = pos + start_positions[:, None]
        return x, pos.expand(B, S)

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
        x, layers = self.backbone(x, positions, "prefill", sizes, None)
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
