"""Latency upper bound for probabilistic scheduling (paper §III.B).

Lemma 2 (order-statistic bound over a *random* k-subset):

  T_i <= min_z  z + sum_j (pi_ij/2) (E[Q_j] - z)
              + sum_j (pi_ij/2) sqrt((E[Q_j] - z)^2 + Var[Q_j])

The bound is convex in z, so the minimizing z is found by bisection on the
derivative

  d/dz = 1 - sum_j pi_ij/2 - sum_j (pi_ij/2) (E[Q_j]-z)/sqrt((E[Q_j]-z)^2+Var)

which is nondecreasing in z, -> 1 - k_i as z -> -inf and -> 1 as z -> +inf.
For k_i == 1 no root exists; the infimum is the closed form
``sum_j pi_ij E[Q_j]``, handled by an explicit branch. Everything is
vectorized over files and runs where its tensors live.
"""
from __future__ import annotations

import torch
from torch import Tensor

from .queueing import ServiceMoments, node_arrival_rates, pk_sojourn_moments

# sum_j pi_ij within this of 1 counts as k_i == 1 (z-infimum edge case)
K1_TOL = 1e-3


def bound_given_z(pi: Tensor, eq: Tensor, varq: Tensor, z: Tensor) -> Tensor:
    """Eq. (5) evaluated at given z. pi: (..., m); z: (...,) broadcastable."""
    x = eq - z[..., None]
    body = 0.5 * pi * (x + torch.sqrt(x**2 + varq))
    return z + torch.sum(body, dim=-1)


def _dbound_dz(pi: Tensor, eq: Tensor, varq: Tensor, z: Tensor) -> Tensor:
    x = eq - z[..., None]
    r = x / torch.sqrt(x**2 + varq)
    return 1.0 - torch.sum(0.5 * pi * (1.0 + r), dim=-1)


def optimal_z(
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    *,
    iters: int = 80,
    instance_ndim: int | None = None,
) -> Tensor:
    """Per-file minimizing z via bisection on the (monotone) derivative.

    The bracket's ``scale`` is one max over an instance's ``eq``/``varq``,
    not a per-row max. An instance is the trailing ``instance_ndim`` axes
    of ``eq``/``varq`` (same rank as ``pi``); axes before them index
    independent instances, each with its own scale, as the reference's
    ``vmap`` gives it. ``None`` takes the whole arrays as one instance.
    ``k_i == 1`` files (``sum_j pi_ij`` within :data:`K1_TOL` of 1) get the
    bisection floor.
    """
    lead = 0 if instance_ndim is None else eq.dim() - instance_ndim
    dims = tuple(range(lead, eq.dim()))
    scale = (
        torch.amax(eq, dim=dims, keepdim=True)
        + torch.sqrt(torch.amax(varq, dim=dims, keepdim=True))
        + 1.0
    )[..., 0]
    batch = pi.shape[:-1]
    floor = torch.full(batch, -64.0, dtype=pi.dtype, device=pi.device) * scale
    lo = floor
    hi = torch.full(batch, 4.0, dtype=pi.dtype, device=pi.device) * scale
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = _dbound_dz(pi, eq, varq, mid) < 0.0
        lo = torch.where(neg, mid, lo)
        hi = torch.where(neg, hi, mid)
    k = torch.sum(pi, dim=-1)
    return torch.where(k <= 1.0 + K1_TOL, floor, 0.5 * (lo + hi))


def file_latency_bounds(pi: Tensor, eq: Tensor, varq: Tensor) -> Tensor:
    """Tightest per-file bound: min_z of Eq. (5). pi: (..., r, m) -> (..., r),
    with eq/varq (..., 1, m) or (..., r, m); each leading index is its own
    instance (one bisection scale over its (r, m)).

    ``k_i == 1`` files return the infimum ``sum_j pi_ij E[Q_j]`` directly.
    """
    z = optimal_z(pi, eq, varq, instance_ndim=2)
    bound = bound_given_z(pi, eq, varq, z)
    k = torch.sum(pi, dim=-1)
    inf_k1 = torch.sum(pi * eq, dim=-1)
    return torch.where(k <= 1.0 + K1_TOL, inf_k1, bound)


def mean_latency_bound(pi: Tensor, lam: Tensor, moments: ServiceMoments) -> Tensor:
    """Request-weighted mean latency bound sum_i (lam_i/lam_hat) T_i.

    Batch-safe: pi may be (..., r, m) with lam (..., r); returns (...,).
    """
    node_rates = node_arrival_rates(pi, lam)
    eq, varq = pk_sojourn_moments(node_rates, moments)
    t = file_latency_bounds(pi, eq[..., None, :], varq[..., None, :])
    return torch.sum(lam * t, dim=-1) / torch.sum(lam, dim=-1)


def shared_z_latency(
    pi: Tensor, z: Tensor, lam: Tensor, moments: ServiceMoments
) -> Tensor:
    """JLCM relaxation, Eq. (9) latency part, with one z for all files:

      z + sum_j Lambda_j/(2 lam_hat) [ X_j + sqrt(X_j^2 + Y_j) ]

    with X_j = E[Q_j] - z, Y_j = Var[Q_j]. Batch-safe: pi (..., r, m),
    z (...,), lam (..., r) -> (...,). The reference's ``weights`` and
    ``extra_rates`` folds are not ported yet (ROADMAP.md queue A).
    """
    node_rates = node_arrival_rates(pi, lam)
    eq, varq = pk_sojourn_moments(node_rates, moments)
    lam_hat = torch.sum(lam, dim=-1)
    x = eq - z[..., None]
    body = node_rates / (2.0 * lam_hat[..., None]) * (x + torch.sqrt(x**2 + varq))
    return z + torch.sum(body, dim=-1)


def optimal_shared_z(
    pi: Tensor, lam: Tensor, moments: ServiceMoments, *, iters: int = 80
) -> Tensor:
    """Minimize Eq. (9) over the single auxiliary z (convex; bisection).

    Batch-safe: pi (..., r, m), lam (..., r) -> z of shape (...,), each
    leading index its own instance.
    """
    node_rates = node_arrival_rates(pi, lam)
    eq, varq = pk_sojourn_moments(node_rates, moments)
    lam_hat = torch.sum(lam, dim=-1)
    w = node_rates / lam_hat[..., None]  # plays the role of pi in the bound
    return optimal_z(w, eq, varq, iters=iters, instance_ndim=1)
