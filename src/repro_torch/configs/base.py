"""Config system for the Percepta reproduction framework (the port's own
copy of ``repro.configs.base``: plain dataclasses, no JAX).

Plain dataclasses (no external deps), a registry, CLI override parsing and a
``reduced()`` transform producing CPU-smoke-testable variants of every
architecture. All 10 assigned architectures live in sibling modules, each
exporting ``CONFIG`` with the exact published numbers.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence

# ---------------------------------------------------------------------------
# Layer kinds used in ``layer_pattern``. A model is a repetition of its
# pattern (truncated to n_layers), scanned over groups for compile speed.
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"      # full causal attention
ATTN_LOCAL = "local"        # sliding-window causal attention
RGLRU = "rglru"             # RG-LRU recurrent block (RecurrentGemma / Griffin)
RWKV = "rwkv"               # RWKV-6 time-mix block (attention-free)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # aux load-balancing loss weight (Switch-style)
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    layer_pattern: tuple = (ATTN_GLOBAL,)
    # --- attention features ------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3-style RMSNorm on q/k heads
    attn_logit_softcap: float = 0.0   # gemma2-style tanh softcap (0 = off)
    final_logit_softcap: float = 0.0
    local_window: int = 4096          # sliding window for ATTN_LOCAL layers
    post_norms: bool = False          # gemma2 post-attn/post-mlp RMSNorms
    tie_embeddings: bool = False
    # --- MoE ----------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- recurrent (RG-LRU / Griffin) ---------------------------------------
    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4               # temporal conv in recurrent block
    # --- RWKV-6 -------------------------------------------------------------
    rwkv_head_dim: int = 64
    # --- modality frontend stubs --------------------------------------------
    # 'none'      : token ids in, logits out (standard LM)
    # 'embeddings': precomputed frame embeddings in (musicgen backbone stub)
    # 'vlm'       : precomputed patch embeddings + token ids (internvl2 stub)
    frontend: str = "none"
    n_patches: int = 256              # VLM: image patches prepended to text
    n_codebooks: int = 4              # musicgen: EnCodec codebooks (codec side)
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # source provenance, for DESIGN/EXPERIMENTS tables
    source: str = ""

    # --- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return all(k in (RGLRU, RWKV) for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode cost is O(1) in context length (long_500k eligible).

        RG-LRU/RWKV layers hold O(1) state; local attention holds a bounded
        window. A single ATTN_GLOBAL layer disqualifies the arch.
        """
        return all(k in (RGLRU, RWKV, ATTN_LOCAL) for k in self.layer_pattern)

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer kind list, pattern repeated and truncated to n_layers."""
        reps = -(-self.n_layers // len(self.layer_pattern))
        return tuple((self.layer_pattern * reps)[: self.n_layers])

    @property
    def n_groups(self) -> int:
        """Number of scanned pattern groups (remainder layers run unscanned)."""
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers - self.n_groups * len(self.layer_pattern)

    # --- parameter counting (for 6ND roofline terms) -------------------------
    def _layer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        n = 0
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            n += q + kv + o + d  # + attn norm
            if self.qk_norm:
                n += 2 * hd
            if self.post_norms:
                n += d
        elif kind == RGLRU:
            w = self.lru_width or d
            # in-proj (x & gate), conv, rg-lru gates (a & input), out-proj
            n += 2 * d * w + self.conv_width * w + 2 * (w * w // 8 + w) + w * d + d
            if self.post_norms:
                n += d
        elif kind == RWKV:
            H = self.d_model // self.rwkv_head_dim
            # r/k/v/g/w projections + time-mix lora + output + ln + u
            n += 5 * d * d + 2 * d * 64 + d + H * self.rwkv_head_dim + d
        # FFN (dense or MoE)
        if kind == RWKV:
            # rwkv channel-mix: k (d->d_ff), v (d_ff->d), r (d->d)
            n += d * self.d_ff + self.d_ff * d + d * d + d
        elif self.moe is not None:
            n += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            n += d * self.moe.n_experts  # router
            n += d  # mlp norm
        else:
            n += 3 * d * self.d_ff + d
        return n

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model  # embeddings
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size  # lm head
        n += self.d_model  # final norm
        for kind in self.layer_kinds:
            n += self._layer_params(kind)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        per_layer_experts = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        active_experts = self.moe.experts_per_token * 3 * self.d_model * self.moe.d_ff_expert
        n_moe_layers = sum(1 for k in self.layer_kinds if k not in (RWKV,))
        return full - n_moe_layers * (per_layer_experts - active_experts)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


# The four assigned LM shapes (identical across the 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    remat_policy: str = "full"        # none | dots | full
    microbatches: int = 1             # gradient accumulation
    zero1: bool = True                # shard optimizer state over data axis
    grad_compression: str = "none"    # none | int8_ef
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True


@dataclass(frozen=True)
class ShardingConfig:
    """The hillclimb lever: how logical dims map onto mesh axes."""
    layout: str = "zero3"             # zero3 (params stored model+data-sharded,
                                      # gathered per layer in-scan) | tp
    seq_parallel: bool = False        # Megatron-SP residual stream (hillclimb)
    shard_experts: bool = True
    zero1: bool = True
    # decode: shard KV-cache sequence dim over 'model' when heads don't divide
    shard_cache_seq: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    offload_opt_state: bool = False   # (documented lever; host offload)
    # model-structure perf levers (hillclimb)
    attn_sharding: str = "auto"       # auto | heads | ctx
    rwkv_chunk: int = 0               # 0 = exact sequential scan
    q_chunk: int = 512                # blockwise-attention Q tile
    kv_chunk: int = 1024              # blockwise-attention KV tile
    embed_shard: str = "vocab"        # vocab | d_model (embedding table dim)


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig
    shape: ShapeConfig
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    multi_pod: bool = False


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
            d_ff: int = 128, vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests.

    Keeps the structural features (pattern, GQA ratio, MoE top-k, qk_norm,
    softcaps) while shrinking width/depth/vocab/experts.
    """
    n_heads = 4 if cfg.n_heads else 0
    n_kv = 0
    if cfg.n_heads:
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
    pattern_len = len(cfg.layer_pattern)
    n_layers = max(n_layers, pattern_len)  # at least one full pattern group
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, n_experts=min(8, cfg.moe.n_experts),
                      experts_per_token=min(2, cfg.moe.experts_per_token),
                      d_ff_expert=d_ff // 2)
    return replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(16 if cfg.n_heads else 0),
        d_ff=d_ff,
        vocab_size=vocab,
        moe=moe,
        lru_width=(d_model if cfg.lru_width else 0),
        rwkv_head_dim=16,
        local_window=32,
        n_patches=8,
        dtype="float32",
        param_dtype="float32",
    )


def shapes_for(cfg: ModelConfig) -> dict:
    """The dry-run cells for one arch, honoring the long_500k skip rule."""
    out = {}
    for name, shape in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            continue
        out[name] = shape
    return out


def skipped_shapes_for(cfg: ModelConfig) -> dict:
    return {n: s for n, s in SHAPES.items() if n not in shapes_for(cfg)}


def as_flat_dict(cfg: Any, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(as_flat_dict(v, key + "."))
        else:
            out[key] = v
    return out


def apply_overrides(cfg: Any, overrides: Sequence[str]):
    """Apply ``a.b=c`` CLI overrides to a (nested) frozen dataclass."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        cfg = _set_path(cfg, key.split("."), val)
    return cfg


def _set_path(cfg, path, val):
    name = path[0]
    cur = getattr(cfg, name)
    if len(path) > 1:
        return replace(cfg, **{name: _set_path(cur, path[1:], val)})
    typ = type(cur)
    if cur is None:
        parsed = val
    elif typ is bool:
        parsed = val.lower() in ("1", "true", "yes")
    elif typ in (int, float, str):
        parsed = typ(val)
    elif typ is tuple:
        parsed = tuple(val.split(","))
    else:
        raise ValueError(f"cannot override field {name} of type {typ}")
    return replace(cfg, **{name: parsed})
