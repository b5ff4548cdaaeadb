"""Chunked (flash-style) attention for train and prefill.

The port of ``repro/models/attention_opt.py::chunked_sdpa``. The reference
writes it as unrolled XLA tiles with an online softmax, the lax-level twin
of its Pallas kernel ``flash_attention_pallas``, which replaces it one for
one on a TPU. Here the kernel is the only path: CUDA tensors go to kernel
B4 (``repro_torch.kernels.flash_attention``), CPU tensors to its plain twin.
Both never hold the full (Tq, Tk) score matrix and skip nothing that the
mask keeps, so the output is the reference's within float rounding. Under
autograd the wrapper's backward (``flash_attention_backward``, torch ops
tile by tile over key blocks, the same code on both devices) gives dq, dk
and dv, as XLA differentiates the reference's tiles.

``chunked_softmax_xent`` is the reference's chunked cross entropy for
training: static vocab chunks with a running max and sum-exp and the gold
logit, never the (B, S, V) float32 logits at once.
"""
from __future__ import annotations

import torch
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
    """q (B,Tq,H,hd); k (B,Tk,KH,hd), v (B,Tk,KH,vd) GQA; returns
    (B,Tq,H,vd).

    Queries are at positions 0..Tq-1 against keys 0..Tk-1 with Tq == Tk
    (train / prefill self-attention; decode keeps the naive path). The v
    width may differ from q's and k's, as in the reference (MLA: 192 and
    128); on the card the pair must be one kernel B4 is built for
    (``HEAD_DIMS``). The block sizes only tile the work: a ragged last tile
    is fine, and non-causal attention is run as one key block, so it needs
    no padding.
    """
    if not causal:
        k_blk = k.shape[1]
    return fa.flash_attention(
        q, k, v, scale=float(scale), causal=causal, window=window,
        q_blk=q_blk, k_blk=k_blk,
    )


def chunked_softmax_xent(
    h: Tensor, w: Tensor, labels: Tensor, *, chunk: int = 16384
) -> Tensor:
    """Cross entropy without materializing (B,S,V) float32 logits.

    h (B,S,d), w (d,V), labels (B,S). Static chunks over the vocabulary
    accumulate a running max and sum-exp and the gold logit. Returns
    per-token CE (B,S) in float32 (the caller applies masking / mean).
    """
    b, s, _ = h.shape
    vtot = w.shape[1]
    chunk = min(chunk, vtot)
    labels = labels.long()
    m = torch.full((b, s), fa.NEG, dtype=torch.float32, device=h.device)
    l = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=h.device)
    for vs in range(0, vtot, chunk):
        ve = min(vs + chunk, vtot)
        logits = (h @ w[:, vs:ve]).float()  # (B,S,c)
        m_new = torch.maximum(m, logits.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
        in_chunk = (labels >= vs) & (labels < ve)
        idx = torch.clamp(labels - vs, 0, ve - vs - 1)
        g = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = torch.where(in_chunk, g, gold)
        m = m_new
    logz = m + torch.log(l)
    return logz - gold
