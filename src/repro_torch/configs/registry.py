"""Registry of all selectable architectures (``--arch <id>``)."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    gemma2_2b,
    internlm2_20b,
    internvl2_26b,
    moonshot_v1_16b_a3b,
    musicgen_medium,
    phi3_5_moe_42b,
    qwen3_0_6b,
    recurrentgemma_2b,
    rwkv6_1_6b,
)
from repro_torch.configs.base import ModelConfig, reduced

_MODULES = {
    "internlm2-20b": internlm2_20b,
    "gemma2-2b": gemma2_2b,
    "qwen3-0.6b": qwen3_0_6b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "musicgen-medium": musicgen_medium,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "internvl2-26b": internvl2_26b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith(":smoke"):
        return reduced(get_config(arch[: -len(":smoke")]))
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
