"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=(RWKV,),
    rwkv_head_dim=64,      # 32 time-mix heads
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)
