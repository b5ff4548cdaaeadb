"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

The reference registers ten architectures. The port builds those whose
layer kinds it has ported; so far that is SmolLM-135M, a plain dense GQA
stack. The other nine raise ``KeyError`` naming ROADMAP A20 (their MoE,
MLA, RG-LRU, RWKV6, encoder-decoder, M-RoPE and local layers come with
it); a name neither package knows raises as in the reference.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import smollm_135m

_MODULES = {"smollm-135m": smollm_135m}

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
    if arch in ARCHS:
        raise KeyError(
            f"arch {arch!r} is not ported yet (ROADMAP A20); ported: {tuple(_MODULES)}"
        )
    raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
