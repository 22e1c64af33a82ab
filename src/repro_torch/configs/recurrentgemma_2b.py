"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 2 recurrent : 1
attention. [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,          # MQA on the attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    # Griffin block pattern: (recurrent, recurrent, local attention)
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)
