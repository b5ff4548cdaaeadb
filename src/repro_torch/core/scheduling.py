"""Probabilistic scheduling (paper §III.A, Theorem 1): Madow sampling.

A subset distribution over k_i-subsets of S_i with per-node inclusion
marginals pi_{i,j} exists iff sum_j pi_{i,j} = k_i and pi in [0,1].
:func:`madow_sample` draws such a subset by systematic sampling. The
uniform ``u`` is an explicit input (where the reference takes a key), so a
caller can hand both packages the same randomness.
"""
from __future__ import annotations

import torch
from torch import Tensor


def madow_sample(u: Tensor, pi: Tensor) -> Tensor:
    """Sample subsets with inclusion probabilities exactly ``pi``.

    ``pi`` is (..., m) with integral row sums k; ``u`` (...) holds one
    U[0, 1) draw per row. Returns a boolean (..., m) mask with exactly k
    True entries per row. Lay the pi_j end to end on [0, k); the grid
    {u, u+1, ..., u+k-1} hits segment j with probability exactly pi_j.
    """
    c = torch.cumsum(pi, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    u = u[..., None]
    # segment j = [c_j, c_{j+1}) is hit iff floor(c_{j+1}-u) > floor(c_j-u)
    hits = torch.floor(c[..., 1:] - u) - torch.floor(c[..., :-1] - u)
    return hits >= 1.0


def madow_sample_batch(u: Tensor, pi: Tensor) -> Tensor:
    """:func:`madow_sample` over the rows of (r, m) ``pi`` with ``u`` (r,)."""
    if u.shape != pi.shape[:1]:
        raise ValueError(
            f"u must be ({pi.shape[0]},) for pi {tuple(pi.shape)}, got {tuple(u.shape)}"
        )
    return madow_sample(u, pi)
