"""InternVL2-26B — InternViT frontend (STUB) + InternLM2-20B language
backbone. ``input_specs()`` provides precomputed patch embeddings per the
assignment. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,      # NOT divisible by 16: exercises sharding fallback
    layer_pattern=(ATTN_GLOBAL,),
    frontend="vlm",
    n_patches=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)
