"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro/models/rglru.py``. Temporal mixing: a short causal
depthwise conv (width 4), then the Real-Gated LRU:

    i_t = sigmoid(W_i x_t)          (input gate)
    r_t = sigmoid(W_a x_t)          (recurrence gate)
    a_t = exp(c * r_t * log sigmoid(Lambda))     (c = 8)
    h_t = a_t .* h_{t-1} + sqrt(1 - a_t^2) .* (i_t .* x_t)

Train and prefill solve the diagonal linear recurrence with a log-depth
doubling scan in torch ops (``_linear_scan``: ceil(log2 T) steps, each a
few launches over the whole (B, T, L) block), where the reference runs
``lax.associative_scan`` with the same combine; the reference has no
kernel for it. Decode is the O(1) update on the carried state. The gates
and the recurrence are computed in float32, and ``lam`` stays float32 in a
model of another dtype, as in the reference. The scan sums in another
order than XLA's, so the two agree within float32 rounding, not bitwise.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor

from .config import ModelConfig
from .layers import _init

Params = dict[str, Any]
C_FACTOR = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """Random parameters with the reference's distributions: N(0, 1/fan_in)
    projections and conv taps, a zero conv bias, and Lambda uniform in
    [2.2, 6.9) in float32."""
    d = cfg.d_model
    lru = cfg.lru_width or d
    w_y = _init(gen, (d, lru), d, dtype, device)
    w_x = _init(gen, (d, lru), d, dtype, device)
    conv_w = _init(gen, (cfg.conv_width, lru), cfg.conv_width, dtype, device)
    w_i = _init(gen, (lru, lru), lru, dtype, device)
    w_a = _init(gen, (lru, lru), lru, dtype, device)
    lam = torch.rand((lru,), generator=gen, device=device).mul_(6.9 - 2.2).add_(2.2)
    return {
        "w_y": w_y,
        "w_x": w_x,
        "conv_w": conv_w,
        "conv_b": torch.zeros((lru,), dtype=dtype, device=device),
        "w_i": w_i,
        "w_a": w_a,
        "lam": lam,
        "w_out": _init(gen, (lru, d), lru, dtype, device),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, prev: Tensor | None) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv by shifted adds. x (B,S,L); w (cw,L).

    ``prev`` (B,cw-1,L) carries the tail of the previous segment (decode).
    Returns (y, new_prev)."""
    cw = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)  # (B, S+cw-1, L)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[cw - 1 - i] for i in range(cw))
    return y + b, xp[:, xp.shape[1] - (cw - 1):, :]


def _linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a doubling
    (Hillis-Steele) scan of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``: after the step of
    distance ``d`` each position holds the combine of its last ``2d``
    elements, so ceil(log2 T) steps give every prefix. Returns h."""
    t = a.shape[1]
    for step in range(math.ceil(math.log2(t)) if t > 1 else 0):
        d = 1 << step
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < t:  # the last step needs no products of a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
    return b


def rglru_apply(
    p: Params, x: Tensor, mode: str, cache: Params | None = None
) -> tuple[Tensor, Params | None]:
    """x (B,S,d) -> (y (B,S,d), new_cache); the cache ``{"h": (B,L)
    float32, "conv": (B,cw-1,L)}`` in prefill and decode."""
    s = x.shape[1]
    gate = F.gelu(x @ p["w_y"], approximate="tanh")  # (B,S,L), jax.nn.gelu's default
    xb = x @ p["w_x"]
    prev = cache["conv"] if cache is not None else None
    xb, conv_tail = _causal_conv(xb, p["conv_w"], p["conv_b"], prev)

    i_g = torch.sigmoid(xb @ p["w_i"]).float()
    r_g = torch.sigmoid(xb @ p["w_a"]).float()
    log_a = C_FACTOR * r_g * F.logsigmoid(p["lam"])  # (B,S,L) float32, < 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bterm = beta * i_g * xb.float()

    if mode == "decode":
        assert cache is not None and s == 1
        h = a[:, 0] * cache["h"] + bterm[:, 0]
        hs = h[:, None, :]
        new_cache = {"h": h, "conv": conv_tail}
    else:
        hs = _linear_scan(a, bterm)
        new_cache = {"h": hs[:, -1, :], "conv": conv_tail} if mode == "prefill" else None

    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    return y, new_cache
