"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) — MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA per the assignment (GQA kv=16)
    head_dim=128,
    d_ff=1408,             # per-expert FFN width
    vocab_size=163840,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(n_experts=64, experts_per_token=6, d_ff_expert=1408),
    rope_theta=50000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
