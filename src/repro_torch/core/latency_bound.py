"""Latency upper bound for probabilistic scheduling (paper §III.B).

Lemma 2 (order-statistic bound over a *random* k-subset):

  T_i <= min_z  z + sum_j (pi_ij/2) (E[Q_j] - z)
              + sum_j (pi_ij/2) sqrt((E[Q_j] - z)^2 + Var[Q_j])

The bound is convex in z, so the minimizing z is found by bisection on the
derivative

  d/dz = 1 - sum_j pi_ij/2 - sum_j (pi_ij/2) (E[Q_j]-z)/sqrt((E[Q_j]-z)^2+Var)

which is nondecreasing in z, -> 1 - k_i as z -> -inf and -> 1 as z -> +inf.
For k_i == 1 no root exists; the infimum is the closed form
``sum_j pi_ij E[Q_j]``, handled by an explicit branch.

Beyond the paper's mean bound, :func:`tail_probability_bounds` gives the
z-parameterized tail bound ``P[T_i > d]`` from the same order-statistic
machinery (the objective layer's tail terms, ``core/objectives.py``), and
:func:`shared_z_latency` / :func:`optimal_shared_z` take optional per-file
weights (a differentiated, multi-tenant mean) and background node rates.
Everything is vectorized over files and runs where its tensors live.
"""
from __future__ import annotations

import torch
from torch import Tensor

from .projection import bracket_fixed
from .queueing import ServiceMoments, node_arrival_rates, pk_sojourn_moments

# sum_j pi_ij within this of 1 counts as k_i == 1 (z-infimum edge case)
K1_TOL = 1e-3


def bound_given_z(pi: Tensor, eq: Tensor, varq: Tensor, z: Tensor) -> Tensor:
    """Eq. (5) evaluated at given z. pi: (..., m); z: (...,) broadcastable."""
    x = eq - z[..., None]
    body = 0.5 * pi * (x + torch.sqrt(x**2 + varq))
    return z + torch.sum(body, dim=-1)


def _dbound_dz_negative(half_pi: Tensor, eq: Tensor, varq: Tensor, z: Tensor) -> Tensor:
    """Whether the derivative ``1 - sum_j (pi_ij/2) (1 + r_j)`` is below 0,
    from ``half_pi = 0.5 * pi``: the sum exceeds 1 exactly when 1 minus it
    is negative (near 1 the subtraction is exact), so the sum is compared."""
    x = eq - z[..., None]
    r = x / torch.sqrt(x**2 + varq)
    return torch.sum(half_pi * (1.0 + r), dim=-1) > 1.0


def _instance_scale(eq: Tensor, varq: Tensor, instance_ndim: int | None) -> Tensor:
    """``max(eq) + sqrt(max(varq)) + 1`` over each instance: the trailing
    ``instance_ndim`` axes of ``eq``/``varq`` (``None``: all of them). The
    result keeps one unit axis fewer than the instance, so it broadcasts
    against a per-file (or per-instance) bisection bracket."""
    lead = 0 if instance_ndim is None else eq.dim() - instance_ndim
    dims = tuple(range(lead, eq.dim()))
    return (
        torch.amax(eq, dim=dims, keepdim=True)
        + torch.sqrt(torch.amax(varq, dim=dims, keepdim=True))
        + 1.0
    )[..., 0]


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
    bisection floor. On host tensors the loop stops at its bracket's fixed
    point (``projection.bracket_fixed``), with the same result.
    """
    scale = _instance_scale(eq, varq, instance_ndim)
    batch = pi.shape[:-1]
    floor = torch.full(batch, -64.0, dtype=pi.dtype, device=pi.device) * scale
    lo = floor
    hi = torch.full(batch, 4.0, dtype=pi.dtype, device=pi.device) * scale
    half_pi = 0.5 * pi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = _dbound_dz_negative(half_pi, eq, varq, mid)
        new_lo = torch.where(neg, mid, lo)
        new_hi = torch.where(neg, hi, mid)
        if bracket_fixed(lo, hi, new_lo, new_hi):
            break  # the remaining steps would leave it as it is
        lo, hi = new_lo, new_hi
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




INVPHI = 0.6180339887498949  # 1/phi, the golden-section ratio


def tail_probability_bounds(
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    deadline,
    *,
    iters: int = 54,
    instance_ndim: int | None = None,
) -> Tensor:
    """Upper bound on the per-file tail probability P[T_i > d_i].

    For any z < d, ``T_i <= z + sum_{j in A_i} (Q_j - z)^+`` and Markov on
    ``(T_i - z)^+`` give ``P[T_i > d] <= N_i(z) / (d - z)`` with
    ``N_i(z) = sum_j (pi_ij/2) [(E[Q_j] - z) + sqrt((E[Q_j]-z)^2 +
    Var[Q_j])]``, the Eq.-(5) body. The ratio is quasiconvex in z; its
    minimizing z is found by golden-section search (no gradient flows
    through it: the envelope theorem), and the value at that z is returned.

    ``pi`` (..., r, m), ``eq``/``varq`` (..., 1, m) or (..., r, m),
    ``deadline`` (..., r) -> (..., r). The bracket's scale is one max over
    each instance's ``eq``/``varq`` (the trailing ``instance_ndim`` axes,
    leading axes a batch, as the reference's ``vmap`` gives it; ``None``:
    the whole arrays, one instance). Values
    above 1 are vacuous; callers clip where they report.
    """
    deadline = torch.as_tensor(deadline, dtype=pi.dtype, device=pi.device)
    half_pi = 0.5 * pi

    def excess(z: Tensor) -> Tensor:
        x = eq - z[..., None]
        return torch.sum(half_pi * (x + torch.sqrt(x**2 + varq)), dim=-1)

    scale = _instance_scale(eq, varq, instance_ndim)
    lo = deadline - 64.0 * scale
    hi = deadline - 1e-6 * scale
    with torch.no_grad():
        # the search runs ~13 small ops a step: both probes in one pass
        # over (2, ..., r, m), sqrt(x^2 + Var) as hypot(x, sd)
        sd = torch.sqrt(varq)
        # built on the device (no host copy: the solver's iterations are a
        # guarded hot path, diag.py)
        toward = torch.stack([torch.full((), v, dtype=pi.dtype, device=pi.device)
                              for v in (-INVPHI, INVPHI)])
        toward = toward.reshape((2,) + (1,) * lo.dim())
        for _ in range(iters):
            probes = torch.stack((hi, lo)) + toward * (hi - lo)  # (a, b)
            x = eq - probes[..., None]
            f = torch.sum(half_pi * (x + torch.hypot(x, sd)), dim=-1) / (deadline - probes)
            shrink_hi = f[0] < f[1]  # the minimum is left of b
            new_lo = torch.where(shrink_hi, lo, probes[0])
            new_hi = torch.where(shrink_hi, probes[1], hi)
            if bracket_fixed(lo, hi, new_lo, new_hi):
                break  # the remaining steps would leave it as it is
            lo, hi = new_lo, new_hi
    z = 0.5 * (lo + hi)
    return excess(z) / (deadline - z)


def _queues_and_fold(
    pi: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    weights: Tensor | None,
    extra_rates: Tensor | None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """P-K moments at the true rates (plus ``extra_rates``), and the fold
    weights ``sum_i w_i lam_i pi_ij`` with their total ``sum_i w_i lam_i``.
    ``None`` for either option adds no op."""
    node_rates = node_arrival_rates(pi, lam)
    queue_rates = node_rates if extra_rates is None else node_rates + extra_rates
    eq, varq = pk_sojourn_moments(queue_rates, moments)
    if weights is None:
        wlam, fold = lam, node_rates
    else:
        wlam = lam * weights
        fold = node_arrival_rates(pi, wlam)
    return eq, varq, fold, torch.sum(wlam, dim=-1)


def shared_z_latency(
    pi: Tensor,
    z: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    *,
    weights: Tensor | None = None,
    extra_rates: Tensor | None = None,
) -> Tensor:
    """JLCM relaxation, Eq. (9) latency part, with one z for all files:

      z + sum_j Lambda_j/(2 lam_hat) [ X_j + sqrt(X_j^2 + Y_j) ]

    with X_j = E[Q_j] - z, Y_j = Var[Q_j]. Batch-safe: pi (..., r, m),
    z (...,), lam (..., r) -> (...,).

    ``weights`` (..., r) gives the differentiated weighted mean
    ``sum_i (w_i lam_i / W) T_i``: the fold is re-weighted, the P-K moments
    stay on the true rates. ``extra_rates`` (..., m) adds background
    traffic to the queues without joining the fold. ``None`` adds no op.
    """
    eq, varq, fold, lam_hat = _queues_and_fold(pi, lam, moments, weights, extra_rates)
    x = eq - z[..., None]
    body = fold / (2.0 * lam_hat[..., None]) * (x + torch.sqrt(x**2 + varq))
    return z + torch.sum(body, dim=-1)


def optimal_shared_z(
    pi: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    *,
    weights: Tensor | None = None,
    extra_rates: Tensor | None = None,
    iters: int = 80,
) -> Tensor:
    """Minimize Eq. (9) over the single auxiliary z (convex; bisection).

    Batch-safe: pi (..., r, m), lam (..., r) -> z of shape (...,), each
    leading index its own instance. ``weights`` and ``extra_rates`` as in
    :func:`shared_z_latency`.
    """
    eq, varq, fold, lam_hat = _queues_and_fold(pi, lam, moments, weights, extra_rates)
    w = fold / lam_hat[..., None]  # plays the role of pi in the bound
    return optimal_z(w, eq, varq, iters=iters, instance_ndim=1)
