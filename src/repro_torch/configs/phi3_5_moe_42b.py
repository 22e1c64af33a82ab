"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,             # per-expert FFN width
    vocab_size=32064,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(n_experts=16, experts_per_token=2, d_ff_expert=6400),
    rope_theta=10000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
