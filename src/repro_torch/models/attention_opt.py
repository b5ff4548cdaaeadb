"""Chunked (flash-style) attention for train and prefill.

The port of ``repro/models/attention_opt.py::chunked_sdpa``. The reference
writes it as unrolled XLA tiles with an online softmax, the lax-level twin
of its Pallas kernel ``flash_attention_pallas``, which replaces it one for
one on a TPU. Here the kernel is the only path: CUDA tensors go to kernel
B4 (``repro_torch.kernels.flash_attention``), CPU tensors to its plain twin.
Both never hold the full (Tq, Tk) score matrix and skip nothing that the
mask keeps, so the output is the reference's within float rounding.

``chunked_softmax_xent`` (chunked cross entropy) is for training and waits
for the training slice (ROADMAP A20).
"""
from __future__ import annotations

from torch import Tensor

from repro_torch.kernels import flash_attention as fa


def chunked_sdpa(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    scale,
    *,
    causal: bool = True,
    window: int | None = None,
    q_blk: int = 1024,
    k_blk: int = 1024,
) -> Tensor:
    """q (B,Tq,H,hd); k/v (B,Tk,KH,hd) GQA; returns (B,Tq,H,hd).

    Queries are at positions 0..Tq-1 against keys 0..Tk-1 with Tq == Tk
    (train / prefill self-attention; decode keeps the naive path). The
    block sizes only tile the work: a ragged last tile is fine, and
    non-causal attention is run as one key block, so it needs no padding.
    """
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "a v head dim other than q's (MLA) is not ported yet (ROADMAP A20)"
        )
    if not causal:
        k_blk = k.shape[1]
    return fa.flash_attention(
        q, k, v, scale=float(scale), causal=causal, window=window,
        q_blk=q_blk, k_blk=k_blk,
    )
