"""Core layer primitives: norms, RoPE and M-RoPE, GQA self- and
cross-attention (with per-head q/k norms) and their KV caches, MLA
(DeepSeek's multi-head latent attention, with its absorbed decode over the
compressed cache), and the dense MLP.

The port of ``repro/models/layers.py``. Layers are plain functions over
parameter trees (nested dicts of tensors); the parameters carry the dtype
and the device, activations follow. On a mesh the trees hold DTensors and
the same functions run by DTensor's sharding propagation (the attention
core and the MLP on each rank's block, ``attention_opt.on_local_blocks``
and ``distributed.blocks.local_blocks``); ``pin_batch``,
the reference's GSPMD batch-sharding constraint, re-places a DTensor's
batch dim on the DP axes. The ``stub`` probe (``attn_impl="stub"``, the
dry-run's roofline decomposition) keeps the q/k/v/o projections of train
and prefill attention and drops its core (``attention_opt.stub_sdpa``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.blocks import (grad_placed, local_blocks, merge_last, rows_product,
                                            split_last)

from .attention_opt import chunked_sdpa, on_local_blocks, stub_sdpa
from .config import ModelConfig

Params = dict[str, Any]


class Ctx(NamedTuple):
    """Per-call context threaded through the stack."""

    mode: str  # "train" | "prefill" | "decode"
    positions: Tensor | None = None  # (B,S) or (3,B,S) for M-RoPE
    decode_pos: Tensor | None = None  # (B,) current write index for decode
    enc_out: Tensor | None = None  # (B, S_enc, d) encoder memory (enc-dec)
    cache_len: int = 0  # static cache capacity S for decode
    attn_impl: str = "naive"  # "naive" | "chunked" (kernel B4) | "stub"
    attn_q_blk: int = 1024
    attn_k_blk: int = 1024
    cache_update: str = "onehot"  # "onehot" | "dus"
    ep: Any = None  # moe.EPSpec: the expert-parallel island on a mesh
    pin_mesh: Any = None  # DeviceMesh: batch-sharding pins at attention
    pin_axes: tuple = ()


def pin_batch(x: Tensor, ctx: Ctx) -> Tensor:
    """Re-place a DTensor's batch dim on the DP axes ``ctx.pin_axes`` (and
    replicate it over the other mesh axes) when the batch divides them; a
    plain tensor, or a context without a mesh, passes as it is."""
    if ctx.pin_mesh is None or not ctx.pin_axes or not isinstance(x, DTensor):
        return x
    mesh = ctx.pin_mesh
    names = mesh.mesh_dim_names
    dp = math.prod(mesh.size(names.index(a)) for a in ctx.pin_axes)
    if x.shape[0] % dp != 0:
        return x
    return x.redistribute(mesh, [Shard(0) if a in ctx.pin_axes else Replicate() for a in names])


def _init(gen: torch.Generator, shape, fan_in: int, dtype, device) -> Tensor:
    """N(0, 1/fan_in), scaled in place: no second tensor of the leaf's size
    (an expert leaf of DeepSeek-V3 is 15 GB in float32)."""
    x = torch.randn(shape, generator=gen, device=device).div_(math.sqrt(fan_in))
    return x.to(dtype)


def _to_cache_layout(x: Tensor, s: int) -> Tensor:
    """Arrange prefill K/V (B, t, ...) into a capacity-s cache buffer.

    If t <= s: pad with zeros (slot p holds token p). If t > s (rolling
    window buffer): keep the last s tokens, each token p stored at slot
    p % s — matching the decode-time rolling write."""
    t = x.shape[1]
    if t == s:
        return x
    if t < s:
        out = x.new_zeros((x.shape[0], s) + tuple(x.shape[2:]))
        out[:, :t] = x
        return out
    keep = x[:, t - s:]
    slots = torch.arange(t - s, t, device=x.device) % s
    out = torch.zeros_like(keep)
    out[:, slots] = keep
    return out


# --------------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"]


# ---------------------------------------------------------------------- rope
def rope_angles(
    positions: Tensor, rot_dim: int, theta: float, sections=None
) -> tuple[Tensor, Tensor]:
    """positions (B,S) -> cos/sin (B,S,rot_dim/2). M-RoPE: positions (3,B,S)
    with ``sections`` (t,h,w) splitting the rot_dim/2 frequencies."""
    half = rot_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    if sections is None:
        if positions.dim() == 3:  # M-RoPE positions given but plain rope asked
            positions = positions[0]
        ang = positions.float()[..., None] * freqs  # (B,S,half)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3,B,S) positions, got {tuple(positions.shape)}")
        bounds = torch.cumsum(torch.tensor(sections, device=positions.device), 0)
        idx = torch.searchsorted(bounds, torch.arange(half, device=positions.device),
                                 right=True)  # 0/1/2: the t, h or w stream
        ang = positions.movedim(0, -1).float()[..., idx] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x (B,S,H,hd) with rotating first 2*half dims; cos/sin (B,S,half)."""
    half = cos.shape[-1]
    rot, keep = x[..., : 2 * half], x[..., 2 * half:]
    x1, x2 = rot[..., :half], rot[..., half:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), keep], dim=-1)


# ----------------------------------------------------------------- attention
def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": _init(gen, (d, h * hd), d, dtype, device),
        "wk": _init(gen, (d, kh * hd), d, dtype, device),
        "wv": _init(gen, (d, kh * hd), d, dtype, device),
        "wo": _init(gen, (h * hd, d), h * hd, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _write_kv(cache: Tensor, new: Tensor, pos: Tensor, mode: str) -> Tensor:
    """Write ``new`` (B,1,...) into ``cache`` (B,S,...) at per-batch ``pos``.

    "onehot": arithmetic select — reads+writes the whole cache (baseline);
    a position outside [0, S) writes nothing, as ``jax.nn.one_hot`` gives.
    "dus": one row per batch entry, the start clamped into [0, S-1] as
    ``lax.dynamic_update_slice`` clamps it. Both return a new tensor."""
    s = cache.shape[1]
    if mode == "dus":
        out = cache.clone()
        rows = torch.arange(cache.shape[0], device=cache.device)
        out[rows, pos.long().clamp(0, s - 1)] = new[:, 0]
        return out
    oh = (torch.arange(s, device=cache.device)[None, :] == pos[:, None]).to(cache.dtype)
    oh = oh.reshape(oh.shape + (1,) * (cache.dim() - 2))
    return cache * (1 - oh) + oh * new


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, scale) -> Tensor:
    """q (B,Tq,H,hd), k/v (B,Tk,KH,hd) with GQA head grouping; mask
    (B,Tq,Tk). On a mesh each rank runs its (batch, head) block
    (``on_local_blocks``): the einsums' merged batch dims would otherwise
    be strided shards, whose redistributions DTensor plans by a graph
    search on every new shape."""
    if isinstance(q, DTensor):
        return on_local_blocks(functools.partial(_sdpa, scale=scale), q, k, v, mask)
    b, tq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    q = q.reshape(b, tq, kh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, tq, h, v.shape[-1])


def attn_apply(
    p: Params,
    x: Tensor,
    ctx: Ctx,
    cfg: ModelConfig,
    *,
    window: int | None = None,
    cache: Params | None = None,
    cross: bool = False,
) -> tuple[Tensor, Params | None]:
    """Causal self-attention, optionally windowed, or with ``cross``
    attention over the encoder memory ``ctx.enc_out``. Returns (y,
    new_cache)."""
    b, t, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = split_last(x @ p["wq"], h, hd)
    if cross and ctx.mode == "decode":
        # encoder memory K/V live in the cross cache; never recomputed
        assert cache is not None
        k, v = cache["k"], cache["v"]
    else:
        kv_src = ctx.enc_out if cross else x
        k = split_last(kv_src @ p["wk"], kh, hd)
        v = split_last(kv_src @ p["wv"], kh, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        if not (cross and ctx.mode == "decode"):
            k = rmsnorm(p["k_norm"], k, cfg.norm_eps)

    rot_dim = int(cfg.rotary_pct * hd) // 2 * 2
    if not cross and rot_dim > 0:
        if ctx.mode == "decode":
            pos_q = ctx.decode_pos[:, None]  # (B,1)
            if cfg.mrope_sections is not None:  # text stream: t=h=w position
                pos_q = pos_q[None].expand((3,) + tuple(pos_q.shape))
        elif ctx.positions is not None:
            pos_q = ctx.positions
        else:
            pos_q = torch.arange(t, device=x.device)[None, :].expand(b, t)
        cos, sin = rope_angles(pos_q, rot_dim, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = 1.0 / math.sqrt(hd)
    new_cache = None

    if cross:
        # full visibility of the encoder memory
        if ctx.mode == "decode":
            new_cache = cache
        elif ctx.mode == "prefill":
            new_cache = {"k": k, "v": v}
        mask = torch.ones((b, t, k.shape[1]), dtype=torch.bool, device=x.device)
        y = _sdpa(q, k, v, mask, scale)
    elif ctx.mode == "decode":
        assert cache is not None
        s = cache["k"].shape[1]
        pos = ctx.decode_pos  # (B,)
        # rolling buffer when the cache is shorter than the stream (local
        # attention): keys carry RoPE at absolute positions, slots are
        # overwritten mod s (Mistral-style sliding window).
        rolling = window is not None and s <= window
        write = pos % s if rolling else pos
        k_cache = pin_batch(_write_kv(cache["k"], k, write, ctx.cache_update), ctx)
        v_cache = pin_batch(_write_kv(cache["v"], v, write, ctx.cache_update), ctx)
        new_cache = {"k": k_cache, "v": v_cache}
        j = torch.arange(s, device=x.device)[None, :]
        if rolling:
            mask = (j <= pos[:, None]) | (pos[:, None] >= s)
        else:
            mask = j <= pos[:, None]
            if window is not None:
                mask &= j > pos[:, None] - window
        y = _sdpa(q, k_cache, v_cache, mask[:, None, :], scale)
    else:  # train / prefill: full causal (optionally windowed) self-attn
        if ctx.attn_impl == "stub":
            y = stub_sdpa(q, k, v)
        elif ctx.attn_impl == "chunked":
            q, k, v = pin_batch(q, ctx), pin_batch(k, ctx), pin_batch(v, ctx)
            y = pin_batch(chunked_sdpa(
                q, k, v, scale, causal=True, window=window,
                q_blk=ctx.attn_q_blk, k_blk=ctx.attn_k_blk,
            ), ctx)
        else:
            i = torch.arange(t, device=x.device)[:, None]
            j = torch.arange(t, device=x.device)[None, :]
            mask = j <= i
            if window is not None:
                mask &= j > i - window
            y = _sdpa(q, k, v, mask[None].expand(b, t, t), scale)
        if ctx.mode == "prefill":
            s = ctx.cache_len or t
            if window is not None:
                s = min(s, window)
            new_cache = {"k": _to_cache_layout(k, s), "v": _to_cache_layout(v, s)}

    return merge_last(y) @ p["wo"], new_cache


# ----------------------------------------------------------------------- MLA
def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": _init(gen, (d, m.q_lora_rank), d, dtype, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "wq_b": _init(gen, (m.q_lora_rank, h * qh), m.q_lora_rank, dtype, device),
        "wkv_a": _init(gen, (d, m.kv_lora_rank + m.rope_head_dim), d, dtype, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_uk": _init(gen, (m.kv_lora_rank, h * m.nope_head_dim), m.kv_lora_rank, dtype, device),
        "w_uv": _init(gen, (m.kv_lora_rank, h * m.v_head_dim), m.kv_lora_rank, dtype, device),
        "wo": _init(gen, (h * m.v_head_dim, d), h * m.v_head_dim, dtype, device),
    }


def mla_apply(
    p: Params, x: Tensor, ctx: Ctx, cfg: ModelConfig, *, cache: Params | None = None
) -> tuple[Tensor, Params | None]:
    """DeepSeek MLA. Train / prefill: K and V expanded per head from the
    latent, then attention with q/k width nope + rope and v width v_head_dim
    (``_sdpa``, or ``chunked_sdpa``: kernel B4 on the card); decode: the
    absorbed form over the compressed (c_kv, k_pe) cache, which stores
    kv_lora_rank + rope_head_dim values a token instead of 2 * H * hd. The
    RoPE part of the keys is one 64-wide vector a token shared by every
    head. Returns (y, new_cache)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim

    # the latents, whole on every rank, feed products split over ``model``:
    # their gradients come back placed as they are, as a block's input's do
    # (``stack.block_apply``)
    q = grad_placed(rmsnorm(p["q_norm"], rows_product(x, p["wq_a"]), cfg.norm_eps)) @ p["wq_b"]
    q = split_last(q, h, nd + rd)
    q_nope, q_pe = q[..., :nd], q[..., nd:]

    kv_a = rows_product(x, p["wkv_a"])  # (B,T, rank+rd)
    c_kv = grad_placed(rmsnorm(p["kv_norm"], kv_a[..., :m.kv_lora_rank], cfg.norm_eps))
    k_pe_raw = kv_a[..., m.kv_lora_rank:]  # (B,T,rd), shared across heads

    if ctx.mode == "decode":
        pos_q = ctx.decode_pos[:, None]
    elif ctx.positions is not None:
        pos_q = ctx.positions
    else:
        pos_q = torch.arange(t, device=x.device)[None, :].expand(b, t)
    cos, sin = rope_angles(pos_q, rd, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe_raw[:, :, None, :], cos, sin)[:, :, 0, :]

    scale = 1.0 / math.sqrt(nd + rd)
    new_cache = None

    if ctx.mode == "decode":
        assert cache is not None
        s = cache["ckv"].shape[1]
        pos = ctx.decode_pos
        ckv = pin_batch(_write_kv(cache["ckv"], c_kv, pos, ctx.cache_update), ctx)
        kpe = pin_batch(_write_kv(cache["kpe"], k_pe, pos, ctx.cache_update), ctx)
        new_cache = {"ckv": ckv, "kpe": kpe}
        # absorbed: q_eff[h] = W_uk[h]^T q_nope[h], in latent space
        w_uk = split_last(p["w_uk"], h, nd)
        q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)  # (B,1,H,rank)
        logits = (
            torch.einsum("bqhr,bsr->bhqs", q_eff, ckv)
            + torch.einsum("bqhd,bsd->bhqs", q_pe, kpe)
        ).float() * scale
        j = torch.arange(s, device=x.device)[None, None, None, :]
        logits = torch.where(j <= pos[:, None, None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv)  # (B,1,H,rank)
        w_uv = split_last(p["w_uv"], h, vd)
        out = torch.einsum("bqhr,rhv->bqhv", ctx_lat, w_uv)
    else:
        # expand K and V per head from the latent
        k_nope = split_last(c_kv @ p["w_uk"], h, nd)
        v = split_last(c_kv @ p["w_uv"], h, vd)
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, t, h, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        if ctx.attn_impl == "stub":
            out = stub_sdpa(q_full, k_full, v)
        elif ctx.attn_impl == "chunked":
            q_full, k_full, v = pin_batch(q_full, ctx), pin_batch(k_full, ctx), pin_batch(v, ctx)
            out = pin_batch(chunked_sdpa(
                q_full, k_full, v, scale, causal=True, window=None,
                q_blk=ctx.attn_q_blk, k_blk=ctx.attn_k_blk,
            ), ctx)
        else:
            i = torch.arange(t, device=x.device)[:, None]
            j = torch.arange(t, device=x.device)[None, :]
            out = _sdpa(q_full, k_full, v, (j <= i)[None].expand(b, t, t), scale)
        if ctx.mode == "prefill":
            s = ctx.cache_len or t
            new_cache = {"ckv": _to_cache_layout(c_kv, s), "kpe": _to_cache_layout(k_pe, s)}

    return merge_last(out) @ p["wo"], new_cache


# ----------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, ff: int, dtype, device) -> Params:
    return {
        "w_gate": _init(gen, (d, ff), d, dtype, device),
        "w_up": _init(gen, (d, ff), d, dtype, device),
        "w_down": _init(gen, (ff, d), ff, dtype, device),
    }


def mlp_apply(p: Params, x: Tensor) -> Tensor:
    """SwiGLU over x's last dim. On a mesh each rank runs its block
    (``local_blocks``): its batch rows against its columns of ff, the
    weights' FSDP shards of d gathered; the output is the down-projection's
    partial sum over ``model`` (``stack.block_apply`` sums it at the
    residual add)."""
    w = (p["w_gate"], p["w_up"], p["w_down"])
    if isinstance(x, DTensor):
        return local_blocks(_swiglu, (x,) + w, [(0, None), (None, 1), (None, 1), (None, 0)],
                            [(0, None)])
    return _swiglu(x, *w)


def _swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
