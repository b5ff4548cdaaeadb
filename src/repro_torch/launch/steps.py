"""Model building with the reference's optimisation levels.

The port of ``repro/launch/steps.py::OPT_LEVELS`` and ``build_model``. There
is no mesh on one card: the MoE expert island and the ``pin`` knob (GSPMD
batch-sharding constraints) have nothing to act on, so ``pin`` is dropped.
``remat`` and ``vocab_chunk`` act on training only; they are accepted and
dropped until the training slice, which also brings the train steps
(ROADMAP A20).
"""
from __future__ import annotations

import torch

from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.storage.cluster import _device

# The reference's levels (its EXPERIMENTS.md §Perf). O1 and up run prefill
# attention on the chunked path, which is kernel B4 on the card.
_O1 = dict(attn_impl="chunked", attn_q_blk=1024, attn_k_blk=2048)
_O2 = dict(_O1, vocab_chunk=32768, pin=True)
OPT_LEVELS: dict[str, dict] = {
    "O0": {},
    "O1": _O1,
    "O2": _O2,
    "O3": dict(_O2, remat="full"),
    "O4": dict(_O2, remat="full", cache_update="dus"),
}


def build_model(
    cfg: ModelConfig,
    *,
    dtype=torch.bfloat16,
    remat: str = "dots",
    opt: str = "O0",
    device="cuda",
) -> Model:
    """A model at optimisation level ``opt`` on ``device``."""
    kw = dict(OPT_LEVELS[opt])
    for training_only in ("remat", "pin", "vocab_chunk"):
        kw.pop(training_only, None)
    return Model(cfg=cfg, dtype=dtype, device=_device(device), **kw)
