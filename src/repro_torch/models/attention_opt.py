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

On a mesh (DTensor q, k, v) the kernel runs on local blocks through
``local_map`` (``on_local_blocks``), since its launcher takes raw
pointers: the batch sharded over the DP axes, the heads over ``model``
where both H and KH divide it and replicated otherwise (where the sharding
rules replicate ``wq``, ``wk`` and ``wv``). The autograd wrapper runs
inside unchanged. The naive attention core (``layers._sdpa``) runs on the
same blocks.

``chunked_softmax_xent`` is the reference's chunked cross entropy for
training: static vocab chunks with a running max and sum-exp and the gold
logit, never the (B, S, V) float32 logits at once.
"""
from __future__ import annotations

import functools

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor

from repro_torch.distributed.blocks import local_blocks
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
    run = functools.partial(fa.flash_attention, scale=float(scale), causal=causal,
                            window=window, q_blk=q_blk, k_blk=k_blk)
    if isinstance(q, DTensor):
        return on_local_blocks(run, q, k, v)
    return run(q, k, v)


def _stub_core(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    g = q.shape[2] // v.shape[2]
    return torch.repeat_interleave(v, g, dim=2) + 0.0 * q[..., :v.shape[-1]]


def stub_sdpa(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """The dry-run's roofline probe in place of the attention core: v
    repeated over each KV head's query group, plus ``0 * q`` (its first
    vd columns), as the reference's ``attn_impl="stub"``. The projections
    around it stay, so a run with the stub counts everything but the core,
    whose device cost the dry-run adds back analytically. On a mesh it runs
    where the core runs, on each rank's block."""
    if isinstance(q, DTensor):
        return on_local_blocks(_stub_core, q, k, v)
    return _stub_core(q, k, v)


def on_local_blocks(run, q: Tensor, k: Tensor, v: Tensor, *rest: Tensor) -> Tensor:
    """``run(q, k, v, *rest)`` on each rank's block of DTensors
    (``distributed.blocks.local_blocks``): q, k and v (B, T, heads, width)
    by batch and head, each of ``rest`` (batch-leading, e.g. a mask) by
    batch only. The output is placed as q."""
    return local_blocks(run, (q, k, v) + rest, [(0, 2)] * 3 + [(0, None)] * len(rest),
                        [(0, 2)])


def gather_last(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx]`` per row: x (..., V), idx (...) -> (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


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
        g = gather_last(logits, idx)
        gold = torch.where(in_chunk, g, gold)
        m = m_new
    logz = m + torch.log(l)
    return logz - gold
