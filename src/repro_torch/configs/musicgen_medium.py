"""MusicGen-medium — decoder-only LM over EnCodec tokens (MHA).
The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings; the backbone is the transformer below.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,         # MHA
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,       # EnCodec codebook size
    layer_pattern=(ATTN_GLOBAL,),
    frontend="embeddings",  # precomputed EnCodec frame embeddings in
    n_codebooks=4,
    rope_theta=10000.0,
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)
