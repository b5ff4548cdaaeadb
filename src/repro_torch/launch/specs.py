"""Input specs for every (arch x shape) dry-run cell, as ``meta`` tensors.

The port of ``repro/launch/specs.py``. Where the reference returns
``ShapeDtypeStruct``s and ``eval_shape`` trees, the port returns tensors
on the ``meta`` device: shapes and dtypes, never allocated.

Skip policy: long_500k only for sub-quadratic archs; decode shapes run for
every arch (SeamlessM4T is an encoder-decoder and does decode).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import SHAPES, Model
from repro_torch.models.config import ModelConfig, ShapeConfig

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def cell_is_runnable(arch: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode skipped (DESIGN §4)"
    return True, ""


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s), torch.int32)}
    if cfg.family == "audio":
        specs["enc_embeds"] = _spec((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        n_patch = min(256, s // 2)
        specs["patch_embeds"] = _spec((b, n_patch, cfg.d_model), torch.bfloat16)
        specs["positions"] = _spec((3, b, s), torch.int32)
    return specs


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"token": _spec((b,), torch.int32), "pos": _spec((b,), torch.int32)}


def cache_specs(model: Model, shape: ShapeConfig):
    """The decode cache tree on ``meta`` (never allocated)."""
    meta = dataclasses.replace(model, device=META)
    return meta.empty_caches(shape.global_batch, shape.seq_len)


def batch_specs_for(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "decode":
        return decode_batch_specs(cfg, shape)
    return train_batch_specs(cfg, shape)
