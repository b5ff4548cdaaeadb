"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

The reference registers ten architectures, and the port builds all ten:
SmolLM-135M, the five GQA models of head width 128 (StarCoder2,
Phi-4-mini, Gemma3 with its q/k norm and local layers, the Qwen3 MoE,
Qwen2-VL with M-RoPE), DeepSeek-V3 (MLA, 256 routed experts and a shared
one, three leading dense layers), the encoder-decoder SeamlessM4T-medium,
RecurrentGemma-2B (RG-LRU layers beside MQA local attention at head width
256) and the attention-free RWKV6-1.6B. A name the registry does not know
raises ``KeyError``, as in the reference.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
    deepseek_v3_671b,
    gemma3_27b,
    phi4_mini_3p8b,
    qwen2_vl_2b,
    qwen3_moe_30b_a3b,
    recurrentgemma_2b,
    rwkv6_1p6b,
    seamless_m4t_medium,
    smollm_135m,
    starcoder2_15b,
)

_MODULES = {
    "smollm-135m": smollm_135m,
    "starcoder2-15b": starcoder2_15b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "gemma3-27b": gemma3_27b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "recurrentgemma-2b": recurrentgemma_2b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "rwkv6-1.6b": rwkv6_1p6b,
}

ARCHS = (
    "smollm-135m",
    "starcoder2-15b",
    "phi4-mini-3.8b",
    "gemma3-27b",
    "qwen3-moe-30b-a3b",
    "deepseek-v3-671b",
    "seamless-m4t-medium",
    "recurrentgemma-2b",
    "qwen2-vl-2b",
    "rwkv6-1.6b",
)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
