"""Architecture configuration for all assigned model families.

A copy of ``repro/models/config.py`` (plain frozen dataclasses, no JAX), so
that the port imports nothing of the reference. The layer stack is
described by ``prefix`` (leading layers), ``period`` (a repeating pattern
run ``n_periods`` times; the reference scans it) and ``suffix`` (trailing
layers). Layer kinds (the port runs all of them):

  attn    — full causal self-attention block (GQA + RoPE) + dense MLP
  local   — sliding-window causal attention block + dense MLP
  dense   — alias of attn (used for MoE models' leading dense layers)
  moe     — attention block + mixture-of-experts MLP
  mla     — multi-head latent attention (DeepSeek) + MoE MLP
  mla_dense — the same attention + dense MLP (DeepSeek's leading layers)
  rglru   — RG-LRU recurrent block (RecurrentGemma) + gated MLP
  rwkv    — RWKV6 time-mix + channel-mix (attention-free)
  enc     — bidirectional encoder block (enc-dec models)
  xattn   — causal self-attention + cross-attention + MLP (decoder side)
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal[
    "attn", "local", "dense", "moe", "mla", "rglru", "rwkv", "enc", "xattn"
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek style
    first_k_dense: int = 0  # leading dense layers before MoE starts
    capacity_factor: float = 1.25  # EP buffer slack; overflow tokens drop
    router_aux_weight: float = 0.001  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # defaults to d_model // n_heads
    # layer stack layout
    prefix: tuple[LayerKind, ...] = ()
    period: tuple[LayerKind, ...] = ("attn",)
    suffix: tuple[LayerKind, ...] = ()
    # attention details
    window: int = 1024  # for "local" layers
    rope_theta: float = 1e4
    rotary_pct: float = 1.0  # fraction of head_dim that rotates (phi4: 0.75)
    qk_norm: bool = False  # gemma3-style per-head q/k RMSNorm
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE
    # encoder (enc-dec models): n_layers counts DECODER layers
    encoder_layers: int = 0
    encoder_seq: int = 512  # stub frontend sequence length (frames/patches)
    # recurrent families
    lru_width: int | None = None  # rglru state width (default d_model)
    rwkv_head_size: int = 64
    conv_width: int = 4
    # mixtures
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # attention classification used for shape skips (see DESIGN §4)
    subquadratic: bool = False  # True => long_500k decode is runnable

    def __post_init__(self):
        n_pattern = len(self.prefix) + len(self.suffix)
        body = self.n_layers - n_pattern
        if self.period and body % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by period "
                f"{len(self.period)}"
            )

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.prefix) - len(self.suffix)
        return body // len(self.period) if self.period else 0

    @property
    def layer_kinds(self) -> tuple[LayerKind, ...]:
        return self.prefix + self.period * self.n_periods + self.suffix

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
