"""RWKV6 ("Finch") attention-free block: time-mix with data-dependent decay
plus squared-ReLU channel-mix.

The port of ``repro/models/rwkv6.py``. Time-mix state per head: S in
R^{hd x hd} (key x value outer-product memory)

    w_t = exp(-exp(w0 + tanh(x_t A) B))         (data-dependent decay, LoRA)
    o_t = r_t @ (S_{t-1} + (u .* k_t) v_t^T)    (u = per-head bonus)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Train and prefill walk the recurrence one token at a time in a Python loop
(``_wkv_scan``), where the reference runs ``lax.scan``; the reference has
no kernel for it. Decode is one step of the same recurrence. State math in
float32; ``decay_w0`` and ``bonus_u`` stay float32 in a model of another
dtype, as in the reference. Token-shift interpolation uses static
per-channel mix weights, as the reference's does.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.distributed.tensor import DTensor

from repro_torch.distributed.blocks import (grad_placed, local_blocks, placed_like, rows_product,
                                            split_last)

from .config import ModelConfig
from .layers import _init

Params = dict[str, Any]
DECAY_LORA = 64


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """Random parameters with the reference's distributions: uniform [0, 1)
    mix weights, N(0, 1/fan_in) projections, w0 ~ -4 + N(0, 0.3²) and
    u ~ N(0, 0.3²) in float32, unit norm scales."""
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    n_h = d // hd
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=device).to(dtype)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    return {
        "mix": uniform(5, d),  # r,k,v,w,g
        "w_r": _init(gen, (d, d), d, dtype, device),
        "w_k": _init(gen, (d, d), d, dtype, device),
        "w_v": _init(gen, (d, d), d, dtype, device),
        "w_g": _init(gen, (d, d), d, dtype, device),
        "w_o": _init(gen, (d, d), d, dtype, device),
        "decay_w0": -4.0 + normal(d) * 0.3,
        "decay_a": _init(gen, (d, DECAY_LORA), d, dtype, device),
        "decay_b": _init(gen, (DECAY_LORA, d), DECAY_LORA, dtype, device),
        "bonus_u": normal(n_h, hd) * 0.3,
        "ln_scale": ones(n_h, hd),
        # channel-mix
        "cm_mix": uniform(2, d),  # r,k
        "cm_k": _init(gen, (d, cfg.d_ff), d, dtype, device),
        "cm_v": _init(gen, (cfg.d_ff, d), cfg.d_ff, dtype, device),
        "cm_r": _init(gen, (d, d), d, dtype, device),
        # the block owns its two pre-norms (stack adds no extra residual)
        "ln_tm": ones(d),
        "ln_cm": ones(d),
    }


def _rms(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _token_shift(x: Tensor, prev: Tensor | None) -> Tensor:
    """x (B,S,d) -> previous-token stream; ``prev`` (B,d) for decode."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _wkv_step(r_t, k_t, v_t, w_t, u, s):
    """One step of the recurrence on float32 (B,H,hd) rows and state
    (B,H,hd,hd): returns (o_t (B,H,hd), the next state). On a mesh, on each
    rank's (batch, head) block."""
    if isinstance(r_t, DTensor):
        return local_blocks(_wkv_step, (r_t, k_t, v_t, w_t, u, s),
                            [(0, 1)] * 4 + [(None, 0), (0, 1)], [(0, 1), (0, 1)])
    kv = k_t[..., :, None] * v_t[..., None, :]
    o_t = torch.einsum("bhk,bhkv->bhv", r_t, s + u[None, :, :, None] * kv)
    return o_t, w_t[..., None] * s + kv


def _wkv_scan(r, k, v, w, u, state0):
    """Sequential WKV recurrence.

    r,k,w: (B,S,H,hd); v: (B,S,H,hd); state0 (B,H,hd,hd) f32.
    Returns (o (B,S,H,hd) f32, final state). On a mesh the loop runs on each
    rank's (batch, head) block, paying DTensor's host cost once, not once a
    token.
    """
    if isinstance(r, DTensor):
        return local_blocks(_wkv_scan, (r, k, v, w, u, state0),
                            [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)])
    rs, ks, vs, ws = (t.float().movedim(1, 0).contiguous() for t in (r, k, v, w))
    s, outs = state0, []
    for t in range(rs.shape[0]):
        o_t, s = _wkv_step(rs[t], ks[t], vs[t], ws[t], u, s)
        outs.append(o_t)
    return torch.stack(outs, dim=1), s


def rwkv_apply(
    p: Params, x: Tensor, cfg: ModelConfig, mode: str, cache: Params | None = None
) -> tuple[Tensor, Params | None]:
    """The block on the residual stream x (B,S,d): returns (x + time mix +
    channel mix, new_cache); the cache ``{"state", "shift_tm", "shift_cm"}``
    in prefill and decode."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_size
    n_h = d // hd

    # ---- time mix (pre-norm inside; the block owns its residuals)
    # on a mesh the residual stream keeps its placements, as
    # ``stack.block_apply`` keeps them: each mix is placed as the stream
    # before its add, and the products' inputs' gradients come back placed
    # as the inputs
    h1 = grad_placed(_rms(x, p["ln_tm"]))
    prev_tm = cache["shift_tm"] if cache is not None else None
    xprev = _token_shift(h1, prev_tm)
    mix = p["mix"][:, None, None, :]  # (5,1,1,d)
    xr, xk, xv, xw, xg = (h1 * m + xprev * (1 - m) for m in mix)
    r = split_last(xr @ p["w_r"], n_h, hd)
    k = split_last(xk @ p["w_k"], n_h, hd)
    v = split_last(xv @ p["w_v"], n_h, hd)
    g = F.silu(xg @ p["w_g"])
    decay = p["decay_w0"] + torch.tanh(rows_product(xw, p["decay_a"])) @ p["decay_b"]
    w = split_last(torch.exp(-torch.exp(decay.float())), n_h, hd)

    state0 = (
        cache["state"]
        if cache is not None
        else torch.zeros((b, n_h, hd, hd), dtype=torch.float32, device=x.device)
    )
    if mode == "decode":
        o, state = _wkv_step(r[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                             w[:, 0].float(), p["bonus_u"], state0)
        o = o[:, None]
    else:
        o, state = _wkv_scan(r, k, v, w, p["bonus_u"], state0)

    # per-head groupnorm
    o32 = o.float()
    o32 = o32 * torch.rsqrt(torch.mean(o32**2, dim=-1, keepdim=True) + 1e-6)
    o = (o32.to(x.dtype) * p["ln_scale"]).reshape(b, s, d)
    y_tm = (o * g) @ p["w_o"]

    x2 = x + placed_like(y_tm, x)

    # ---- channel mix
    h2 = grad_placed(_rms(x2, p["ln_cm"]))
    prev_cm = cache["shift_cm"] if cache is not None else None
    x2prev = _token_shift(h2, prev_cm)
    mr, mk = p["cm_mix"][:, None, None, :]
    xr2 = h2 * mr + x2prev * (1 - mr)
    xk2 = h2 * mk + x2prev * (1 - mk)
    kk = torch.square(F.relu(xk2 @ p["cm_k"]))
    y_cm = placed_like(kk @ p["cm_v"], x2) * torch.sigmoid(xr2 @ p["cm_r"])

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {
            "state": state,
            "shift_tm": h1[:, -1, :],
            "shift_cm": h2[:, -1, :],
        }
    return x2 + placed_like(y_cm, x2), new_cache  # full residual stream (stack passes through)
