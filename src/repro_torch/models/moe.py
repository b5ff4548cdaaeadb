"""Mixture-of-Experts MLP: top-k token-choice routing, grouped SwiGLU
products per expert, optional shared experts (DeepSeek style).

The port of the local path of ``repro/models/moe.py``: every expert on one
card, capacity ``T * top_k``, so no assignment is dropped. The routing is
the reference's (float32 router logits, softmax, top-k, renormalised
weights, the switch-style load-balance loss). The (token, expert)
assignments are sorted stably by expert, each expert's rows go through its
SwiGLU as plain matrix products (the reference's ``ragged_dot``, which XLA
computes outside any Pallas kernel), and the rows come back by the inverse
permutation as (T, k, d) and are summed over k. That combine is
deterministic, where a scatter-add (``index_add_``) would sum in the order
the card's atomics land.

Splitting the sorted rows by expert needs the group sizes on the host: one
device-to-host read per MoE layer call, counted in
``_expert_compute.host_syncs`` when the sizes live on the card.

The expert-parallel island (the reference's ``shard_map`` paths) waits for
``distributed/`` (ROADMAP A20 item 5); an ``ep`` spec raises.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import Tensor

from .config import ModelConfig, MoEConfig
from .layers import _init, mlp_apply, mlp_init

Params = dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """The router is float32 whatever ``dtype`` is, as in the reference."""
    mc = cfg.moe
    d, e, ff = cfg.d_model, mc.n_experts, mc.d_ff_expert
    p = {
        "router": _init(gen, (d, e), d, torch.float32, device),
        "w_gate": _init(gen, (e, d, ff), d, dtype, device),
        "w_up": _init(gen, (e, d, ff), d, dtype, device),
        "w_down": _init(gen, (e, ff, d), ff, dtype, device),
    }
    if mc.n_shared:
        p["shared"] = mlp_init(gen, d, ff * mc.n_shared, dtype, device)
    return p


def _route(x2d: Tensor, router: Tensor, mc: MoEConfig) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k routing. Returns (weights (T,k), experts (T,k), aux loss)."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    weights, experts = torch.topk(probs, mc.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    # switch-style load-balance loss
    e = router.shape[1]
    chosen = torch.zeros_like(probs).scatter_(1, experts, 1.0)
    aux = mc.router_aux_weight * e * torch.sum(chosen.mean(0) * probs.mean(0))
    return weights.to(x2d.dtype), experts, aux


def _expert_compute(x_sorted: Tensor, group_sizes: Tensor, w_gate: Tensor, w_up: Tensor,
                    w_down: Tensor) -> Tensor:
    """Grouped SwiGLU over the sorted rows (cap, d) -> (cap, d): rows of
    group e through expert e, rows past the last group zero (as
    ``ragged_dot`` leaves them)."""
    if group_sizes.is_cuda:
        _expert_compute.host_syncs += 1
    sizes = group_sizes.tolist()
    rest = x_sorted.shape[0] - sum(sizes)
    gates, ups, downs = torch.unbind(w_gate), torch.unbind(w_up), torch.unbind(w_down)
    out = []
    for e, rows in enumerate(torch.split(x_sorted, sizes + [rest])):
        if e == len(sizes):
            out.append(torch.zeros_like(rows))
        elif rows.shape[0]:
            out.append((F.silu(rows @ gates[e]) * (rows @ ups[e])) @ downs[e])
    return torch.cat(out)


_expert_compute.host_syncs = 0


def _dispatch_compute(
    x2d: Tensor,
    weights: Tensor,
    experts: Tensor,
    n_local_experts: int,
    expert_offset: int,
    cap: int,
    w_gate: Tensor,
    w_up: Tensor,
    w_down: Tensor,
) -> Tensor:
    """Sort the (token, expert) assignments for the local experts, run the
    grouped products over a ``cap``-row buffer, and combine back.
    Assignments to other experts (or beyond capacity) contribute zero."""
    t, k = experts.shape
    flat_e = experts.reshape(-1) - int(expert_offset)  # (T*k,) local expert ids
    flat_w = weights.reshape(-1)
    flat_t = torch.arange(t * k, device=x2d.device) // k
    valid = (flat_e >= 0) & (flat_e < n_local_experts)
    sort_key = torch.where(valid, flat_e, n_local_experts)  # other experts last
    order = torch.argsort(sort_key, stable=True)[:cap]
    e_sorted = sort_key[order]
    w_sorted = torch.where(e_sorted < n_local_experts, flat_w[order], 0.0)
    x_sorted = x2d[flat_t[order]]  # (cap, d)
    group_sizes = torch.bincount(e_sorted, minlength=n_local_experts + 1)[:n_local_experts]
    y_sorted = _expert_compute(x_sorted, group_sizes, w_gate, w_up, w_down)
    y_sorted = y_sorted * w_sorted[:, None].to(y_sorted.dtype)
    # unsort by the inverse permutation to (T, k, d) and sum over k
    y = y_sorted.new_zeros((t * k, x2d.shape[1])).index_put((order,), y_sorted)
    return y.reshape(t, k, -1).sum(1)


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig, ep: Any = None) -> tuple[Tensor, Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss scalar), on the local path."""
    if ep is not None:
        raise NotImplementedError(
            "the MoE expert-parallel island waits for distributed/ (ROADMAP A20 item 5); "
            "the port runs the local path (ep=None)"
        )
    mc = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts, aux = _route(x2d, p["router"], mc)
    y = _dispatch_compute(
        x2d, weights, experts, mc.n_experts, 0, b * s * mc.top_k,  # no dropping
        p["w_gate"], p["w_up"], p["w_down"],
    )
    if mc.n_shared:
        y = y + mlp_apply(p["shared"], x2d)
    return y.reshape(b, s, d), aux
