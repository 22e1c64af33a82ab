"""Qwen3-0.6B — dense GQA with qk-norm. [hf:Qwen/Qwen3-0.6B family]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    layer_pattern=(ATTN_GLOBAL,),
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-0.6B",
)
