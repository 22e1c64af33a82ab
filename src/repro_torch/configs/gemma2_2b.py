"""Gemma2-2B — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    # gemma2 alternates sliding-window and full attention 1:1
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2408.00118; hf:google/gemma-2-2b",
)
