"""Geo-aware client fabric: per-(client-site, node) service heterogeneity.

The paper's prototype (§V.A, Fig. 5) spans three data centers, and the
chunk service time depends on which client site reads from which storage
site. This module restores the client axis so placement can trade
locality against storage cost.

Model. A request for file i issued from client site c and served by node
j draws ``X_{c,j} = D_j + RTT_{c,j} + Exp(bw_{c,j} / B)``, whose raw
moments are closed-form per (c, j) pair (``storage.cluster.GeoFabric.
moments``). File i carries a client mix ``mix_{i,c}``, so the service
time of a file-i request at node j is the mixture with raw moments
``m^{(p)}_{i,j} = sum_c mix_{i,c} m^{(p)}_{c,j}`` (:func:`pair_moments`),
while node j's queue serves every file's traffic: its service
distribution is the arrival-weighted mixture over (i, c)
(:func:`node_mixture_moments`, independent of pi). The P-K waiting terms
belong to the queue and the served request adds its own service moments
(:func:`geo_sojourn_moments`), and the Lemma-2 bound and its shared-z
relaxation (Eq. 9) fold over (file, node) pairs instead of nodes
(:func:`geo_shared_z_latency` / :func:`geo_optimal_shared_z`).

:func:`geo_problem` with a single client site collapses to a plain
problem (``geo=None``), so the one-site fabric is the existing solver
path exactly. A :class:`GeoSpec` is a tuple of tensors: it stacks under
``stack_problems``, and each leading axis is an independent instance.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .latency_bound import optimal_z
from .queueing import RHO_MAX, ServiceMoments, node_arrival_rates


class GeoSpec(NamedTuple):
    """Per-(client-site, node) service moments plus the per-file client mix.

    ``m1``/``m2``/``m3`` are (C, m) raw service moments of the pair
    distributions X_{c,j}; ``mix`` is (r, C) with rows on the simplex.
    """

    m1: Tensor  # (..., C, m) per-pair E[X]
    m2: Tensor  # (..., C, m) per-pair E[X^2]
    m3: Tensor  # (..., C, m) per-pair E[X^3]
    mix: Tensor  # (..., r, C) per-file client mix (rows sum to 1)

    @property
    def n_sites(self) -> int:
        return self.mix.shape[-1]


def make_geo(site_moments: ServiceMoments, mix) -> GeoSpec:
    """Build a :class:`GeoSpec` from (C, m)-shaped site moments and a mix,
    float32 on the moments' device."""
    f32 = lambda x: torch.as_tensor(
        x, dtype=torch.float32, device=site_moments.mu.device
    )
    return GeoSpec(
        m1=f32(site_moments.mean),
        m2=f32(site_moments.m2),
        m3=f32(site_moments.m3),
        mix=f32(mix),
    )


def pair_moments(geo: GeoSpec) -> tuple[Tensor, Tensor, Tensor]:
    """Per-(file, node) mixture raw moments, each (..., r, m): one matmul
    per moment order (raw moments of a mixture mix the raw moments)."""
    return geo.mix @ geo.m1, geo.mix @ geo.m2, geo.mix @ geo.m3


def node_mixture_moments(lam: Tensor, geo: GeoSpec) -> ServiceMoments:
    """Node-level queue service moments under the offered traffic mix.

    Site weights ``w_c = sum_i lam_i mix_ic / lam_hat``, independent of pi.
    Returns (..., m)-shaped :class:`ServiceMoments`, the drop-in for the
    plain model's per-node moments.
    """
    w = torch.sum(lam[..., None] * geo.mix, dim=-2)  # (..., C)
    w = w / torch.sum(lam, dim=-1, keepdim=True)
    m1 = torch.sum(w[..., None] * geo.m1, dim=-2)
    m2 = torch.sum(w[..., None] * geo.m2, dim=-2)
    m3 = torch.sum(w[..., None] * geo.m3, dim=-2)
    return ServiceMoments(mu=1.0 / m1, m2=m2, m3=m3)


def geo_sojourn_moments(
    node_rates: Tensor,
    node_mom: ServiceMoments,
    p1: Tensor,
    p2: Tensor,
    *,
    rho_max: float = RHO_MAX,
) -> tuple[Tensor, Tensor]:
    """Per-(file, node) P-K sojourn moments, (..., r, m):

      E[Q_ij]   = p1_ij + W_j
      Var[Q_ij] = (p2_ij - p1_ij^2) + VarW_j

    with the waiting terms ``W_j`` / ``VarW_j`` of
    ``queueing.pk_sojourn_moments`` at the node mixture moments, and
    denominators clamped at ``1 - rho_max`` like the plain path.
    """
    lam = node_rates
    rho = lam / node_mom.mu
    slack = torch.clamp_min(1.0 - rho, 1.0 - rho_max)
    wait = lam * node_mom.m2 / (2.0 * slack)
    varw = lam * node_mom.m3 / (3.0 * slack) + lam**2 * node_mom.m2**2 / (
        4.0 * slack**2
    )
    eq = p1 + wait[..., None, :]
    varq = (p2 - p1**2) + varw[..., None, :]
    return eq, varq


def geo_eq_varq(pi: Tensor, lam: Tensor, geo: GeoSpec) -> tuple[Tensor, Tensor]:
    """(..., r, m) sojourn moments straight from (pi, lam, geo)."""
    rates = node_arrival_rates(pi, lam)
    node_mom = node_mixture_moments(lam, geo)
    p1, p2, _ = pair_moments(geo)
    return geo_sojourn_moments(rates, node_mom, p1, p2)


def _pair_fold(
    pi: Tensor, lam: Tensor, weights: Tensor | None
) -> tuple[Tensor, Tensor]:
    """Per-pair fold weights ``w_ij = wlam_i pi_ij / W`` and W itself."""
    wlam = lam if weights is None else lam * weights
    w_hat = torch.sum(wlam, dim=-1)
    return wlam[..., None] * pi / w_hat[..., None, None], w_hat


def geo_shared_z_latency(
    pi: Tensor,
    z: Tensor,
    lam: Tensor,
    geo: GeoSpec,
    *,
    weights: Tensor | None = None,
) -> Tensor:
    """Shared-z JLCM latency (Eq. 9) folded over (file, node) pairs:

      z + sum_{i,j} (w_i lam_i pi_ij / 2 W) [X_ij + sqrt(X_ij^2 + Y_ij)]

    ``weights`` re-weights the fold; the queue moments stay on the true
    rates. Batch-safe: pi (..., r, m), z (...,), lam (..., r) -> (...,).
    """
    eq, varq = geo_eq_varq(pi, lam, geo)
    w, _ = _pair_fold(pi, lam, weights)
    x = eq - z[..., None, None]
    body = 0.5 * w * (x + torch.sqrt(x**2 + varq))
    return z + torch.sum(body, dim=(-2, -1))


def geo_optimal_shared_z(
    pi: Tensor,
    lam: Tensor,
    geo: GeoSpec,
    *,
    weights: Tensor | None = None,
    iters: int = 80,
) -> Tensor:
    """argmin_z of :func:`geo_shared_z_latency` (convex; bisection): the
    (r, m) pair axes flattened into one, each pair a "node" of weight
    w_ij for ``latency_bound.optimal_z``."""
    eq, varq = geo_eq_varq(pi, lam, geo)
    w, _ = _pair_fold(pi, lam, weights)
    flat = w.shape[:-2] + (w.shape[-2] * w.shape[-1],)
    return optimal_z(
        w.reshape(flat), eq.reshape(flat), varq.reshape(flat), iters=iters,
        instance_ndim=1,
    )


def geo_problem(
    lam,
    k,
    site_moments: ServiceMoments,
    mix,
    cost,
    theta,
    *,
    mask=None,
    objective=None,
):
    """Build a geo-aware :class:`~.jlcm.JLCMProblem` on the site moments'
    device.

    ``site_moments`` carries (C, m)-shaped per-(client-site, node) moments
    (``storage.cluster.GeoFabric.moments``); ``mix`` is the (r, C) client
    mix. ``moments`` is set to the node mixture
    (:func:`node_mixture_moments`), so the stability penalty and every
    other consumer of node moments works unchanged, while ``geo`` carries
    the per-pair data the latency objective folds over.

    C == 1 collapses to a plain problem (``geo=None``) whose ``moments``
    are the single site's rows: the one-site fabric is the plain solver
    bit for bit.
    """
    from .jlcm import JLCMProblem  # deferred: jlcm imports this module

    f32 = lambda x: torch.as_tensor(
        x, dtype=torch.float32, device=site_moments.mu.device
    )
    mix = f32(mix)
    if mix.dim() != 2:
        raise ValueError(f"mix must be (r, C), got shape {tuple(mix.shape)}")
    lam = f32(lam)
    if mix.shape[0] != lam.shape[-1]:
        raise ValueError(f"mix has {mix.shape[0]} files, lam has {lam.shape[-1]}")
    if mix.shape[-1] == 1:
        mom = ServiceMoments(
            mu=site_moments.mu[0], m2=site_moments.m2[0], m3=site_moments.m3[0]
        )
        return JLCMProblem(lam=lam, k=f32(k), moments=mom, cost=f32(cost),
                           theta=theta, mask=mask, objective=objective)
    geo = make_geo(site_moments, mix)
    return JLCMProblem(lam=lam, k=f32(k), moments=node_mixture_moments(lam, geo),
                       cost=f32(cost), theta=theta, mask=mask,
                       objective=objective, geo=geo)
