"""Probabilistic scheduling (paper §III.A, Theorem 1).

A subset distribution over k_i-subsets of S_i with per-node inclusion
marginals pi_{i,j} exists iff sum_j pi_{i,j} = k_i and pi in [0,1].

* :func:`madow_sample` draws such a subset by systematic sampling. The
  uniform ``u`` is an explicit input (where the reference takes a key), so
  a caller can hand both packages the same randomness.
* :func:`decompose_subsets` writes pi as an explicit convex combination of
  at most m+1 subsets, and :func:`check_feasible` tests Theorem 1's
  conditions. Both are host numpy (audit and tests, never on the device
  path); they accept tensors, which they copy to the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, Tensor) else x)


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


def decompose_subsets(
    pi, *, tol: float = 1e-9, max_iter: int | None = None
) -> list[tuple[float, np.ndarray]]:
    """Explicit P(A) decomposition of the marginals ``pi`` (m,) (Theorem 1).

    Greedy Caratheodory walk on the base polytope of the uniform matroid:
    each step takes the k currently largest coordinates as the subset A and
    the largest step alpha that keeps the residual feasible,
    alpha = min(min_{j in A} pi_j, remaining - max_{j not in A} pi_j).
    Returns a list of (probability, boolean subset mask) summing to ~1.
    """
    pi = np.asarray(_host(pi), np.float64).copy()
    k = int(round(pi.sum()))
    if k == 0:
        return []
    if np.any(pi < -tol) or np.any(pi > 1 + tol):
        raise ValueError("pi outside [0,1]")
    if abs(pi.sum() - k) > 1e-6:
        raise ValueError("sum(pi) must be integral (= k)")
    m = pi.size
    out: list[tuple[float, np.ndarray]] = []
    remaining = 1.0
    max_iter = max_iter or (2 * m + 4)
    for _ in range(max_iter):
        if remaining <= tol:
            break
        order = np.argsort(-pi, kind="stable")
        subset = np.zeros(m, dtype=bool)
        subset[order[:k]] = True
        in_a = pi[subset]
        not_a = pi[~subset]
        # keep the residual feasible for the shrunken polytope:
        #   residual_j >= 0                (step <= min_{j in A} pi_j)
        #   residual_j <= remaining-alpha  (step <= remaining - max_{j not in A} pi_j)
        alpha = float(in_a.min())
        if not_a.size:
            alpha = min(alpha, remaining - float(not_a.max()))
        alpha = min(alpha, remaining)
        if alpha <= tol:  # numerical corner: the rest goes on this subset
            alpha = remaining
        pi[subset] -= alpha
        pi = np.maximum(pi, 0.0)
        remaining -= alpha
        out.append((alpha, subset))
    if remaining > 1e-6:
        raise RuntimeError(f"decomposition failed to converge: {remaining} left")
    return out


def check_feasible(pi, k, mask=None, *, atol=1e-4) -> bool:
    """Theorem-1 feasibility of ``pi`` (..., r, m): the box [0, 1], row sums
    k (..., r), and no mass outside ``mask``, each within ``atol``."""
    pi = _host(pi)
    k = _host(k)
    ok_box = (pi >= -atol).all() and (pi <= 1 + atol).all()
    ok_sum = np.allclose(pi.sum(-1), k, atol=atol * pi.shape[-1])
    ok_mask = True
    if mask is not None:
        ok_mask = (pi[~np.asarray(_host(mask), bool)] <= atol).all()
    return bool(ok_box and ok_sum and ok_mask)
