"""DeepSeek-Coder-33B — llama-arch dense GQA. [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    layer_pattern=(ATTN_GLOBAL,),
    rope_theta=100000.0,
    source="arXiv:2401.14196; hf:deepseek-ai/deepseek-coder-33b-base",
)
