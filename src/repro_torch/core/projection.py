"""Euclidean projection onto the capped simplex (paper's feasibility set).

The probabilistic-scheduling polytope for file i (Theorem 1) is

  P_i = { x in [0,1]^m : sum_j x_j = k_i, x_j = 0 for j not in S_i }.

Projection of v onto P_i is x = clip(v - tau, 0, 1) on the allowed support,
where tau solves g(tau) = sum_j clip(v_j - tau, 0, 1) = k_i. g is
nonincreasing and piecewise-linear; it is solved by bisection, vectorized
over files (all reductions over the last axis, so stacked batches work).

A bisection step is a function of its bracket alone, so once a step leaves
(lo, hi) as it was, every later step does too. On host tensors the
bisections here and in ``latency_bound`` (``optimal_z``, the golden-section
search of ``tail_probability_bounds``) stop at that fixed point
(:func:`bracket_fixed`), after 27-50 of their 60 or 80 steps in a JLCM
solve, with the same result bit for bit; on the card they run every step,
since the check would synchronise the host.
"""
from __future__ import annotations

import torch
from torch import Tensor


def bracket_fixed(lo: Tensor, hi: Tensor, new_lo: Tensor, new_hi: Tensor) -> bool:
    """True on host tensors when a bisection step left its bracket as it
    was, bit for bit (the signs of zeros included; a NaN is never fixed);
    always False on the card, where the check would synchronise."""
    if lo.device.type != "cpu" or not (torch.equal(new_lo, lo) and torch.equal(new_hi, hi)):
        return False
    return (torch.equal(torch.signbit(new_lo), torch.signbit(lo))
            and torch.equal(torch.signbit(new_hi), torch.signbit(hi)))


def project_capped_simplex(
    v: Tensor,
    k,
    mask: Tensor | None = None,
    *,
    iters: int = 60,
) -> Tensor:
    """Project rows of ``v`` (..., r, m) onto {x in [0,1]^m, sum x = k_row}.

    ``mask`` (..., r, m) restricts support: masked-out entries are pinned to
    0 (chunk placement constraint pi_ij = 0 for j not in S_i). ``k`` may be
    a scalar or (..., r) tensor; requires k <= #allowed per row.
    """
    k = torch.as_tensor(k, dtype=v.dtype, device=v.device).expand(v.shape[:-1])
    if mask is None:
        mask = torch.ones_like(v, dtype=torch.bool)
    else:
        mask = mask.bool().expand(v.shape)

    vm = torch.where(mask, v, torch.finfo(v.dtype).min)
    lo = torch.where(mask, v, torch.inf).amin(dim=-1) - 1.0  # g(lo) >= k
    hi = torch.where(mask, v, -torch.inf).amax(dim=-1)  # g(hi) = 0 <= k

    def g(tau: Tensor) -> Tensor:
        x = torch.clamp(vm - tau[..., None], 0.0, 1.0)
        return torch.sum(torch.where(mask, x, 0.0), dim=-1)

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = g(mid) > k  # need larger tau
        new_lo = torch.where(too_big, mid, lo)
        new_hi = torch.where(too_big, hi, mid)
        if bracket_fixed(lo, hi, new_lo, new_hi):
            break  # the remaining steps would leave it as it is
        lo, hi = new_lo, new_hi
    tau = 0.5 * (lo + hi)
    x = torch.clamp(vm - tau[..., None], 0.0, 1.0)
    return torch.where(mask, x, 0.0)


def feasible_uniform(mask: Tensor, k) -> Tensor:
    """A strictly feasible interior start: pi_ij = k_i / |S_i| on support."""
    mask = mask.bool()
    k = torch.as_tensor(k, dtype=torch.float32, device=mask.device)
    n_allowed = torch.sum(mask, dim=-1).to(torch.float32)
    val = (k / n_allowed)[..., None]
    return torch.where(mask, torch.clamp_max(val, 1.0), 0.0)
