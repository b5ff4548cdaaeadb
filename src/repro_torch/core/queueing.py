"""M/G/1 queueing primitives (paper §III.B, Lemma 3).

Under probabilistic scheduling, chunk arrivals at node j form a Poisson
process with rate ``Lambda_j = sum_i lambda_i pi_{i,j}``. Each node is an
M/G/1 FCFS queue; the Pollaczek-Khinchin transform gives mean and variance
of the sojourn time Q_j (queueing + service), Eqs. (6)-(7) of the paper.

Service time X_j at node j has finite first three moments:
  E[X_j] = 1/mu_j,  E[X_j^2] = Gamma_j^2,  E[X_j^3] = hatGamma_j^3.

Functions run where their tensors live; inputs are cast to float32, as the
reference runs with 64-bit floats off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

# Queues at utilisation above this are treated as (smoothly) infeasible.
RHO_MAX = 0.999


class ServiceMoments(NamedTuple):
    """First three raw moments of per-chunk service time at each node."""

    mu: Tensor  # (m,) service rate, 1/E[X]
    m2: Tensor  # (m,) E[X^2]
    m3: Tensor  # (m,) E[X^3]

    @property
    def mean(self) -> Tensor:
        return 1.0 / self.mu

    @property
    def var(self) -> Tensor:
        return self.m2 - (1.0 / self.mu) ** 2

    def validate(self) -> None:
        """Raise ``ValueError`` unless the moments can belong to a service
        distribution: E[X^2] >= E[X]^2 and Lyapunov's E[X^3]^(1/3) >=
        E[X^2]^(1/2), each with slack 1e-9. Host-side check (copies the
        moments to the host)."""
        mean, m2, m3 = (
            np.asarray(torch.as_tensor(x).detach().cpu())
            for x in (self.mean, self.m2, self.m3)
        )
        if (m2 < mean**2 - 1e-9).any():
            raise ValueError("E[X^2] < E[X]^2: not a valid distribution")
        if (m3 ** (1 / 3) < m2 ** (1 / 2) - 1e-9).any():
            raise ValueError("moment sequence violates Lyapunov inequality")


def exponential_moments(mu) -> ServiceMoments:
    """Moments of Exp(mu) service (baselines, and the serving router's
    replicas)."""
    mu = torch.as_tensor(mu, dtype=torch.float32)
    return ServiceMoments(mu=mu, m2=2.0 / mu**2, m3=6.0 / mu**3)


def shifted_exponential_moments(shift, rate) -> ServiceMoments:
    """Moments of ``D + Exp(rate)`` service (RTT + bandwidth-limited read)."""
    d = torch.as_tensor(shift, dtype=torch.float32)
    r = torch.as_tensor(rate, dtype=torch.float32)
    m1 = d + 1.0 / r
    m2 = d**2 + 2.0 * d / r + 2.0 / r**2
    m3 = d**3 + 3.0 * d**2 / r + 6.0 * d / r**2 + 6.0 / r**3
    return ServiceMoments(mu=1.0 / m1, m2=m2, m3=m3)


def fit_shifted_exponential(m1, m2) -> tuple[Tensor, Tensor]:
    """Method-of-moments inverse of :func:`shifted_exponential_moments`.

    Given the first two raw moments (E[X], E[X^2]) per node, the
    exponential part carries all the variance (``s = sqrt(Var[X])``, with
    Var floored at 1e-9, rate = 1/s) and the shift is the rest of the mean,
    clamped to ``D >= 0``. Returns per-node ``(shift D_j, exp rate 1/s_j)``.
    """
    m1 = torch.as_tensor(m1, dtype=torch.float32)
    m2 = torch.as_tensor(m2, dtype=torch.float32, device=m1.device)
    var = torch.clamp_min(m2 - m1**2, 1e-9)
    s = torch.sqrt(var)
    d = torch.clamp_min(m1 - s, 0.0)
    return d, 1.0 / s


def utilisation(node_rates: Tensor, moments: ServiceMoments) -> Tensor:
    """rho_j = Lambda_j / mu_j."""
    return node_rates / moments.mu


def pk_sojourn_moments(
    node_rates: Tensor, moments: ServiceMoments, *, rho_max: float = RHO_MAX
) -> tuple[Tensor, Tensor]:
    """Pollaczek-Khinchin sojourn moments, Eqs. (6)-(7).

      E[Q_j]   = 1/mu_j + Lambda_j Gamma_j^2 / (2 (1 - rho_j))
      Var[Q_j] = sigma_j^2 + Lambda_j hatGamma_j^3 / (3 (1 - rho_j))
                 + Lambda_j^2 Gamma_j^4 / (4 (1 - rho_j)^2)

    The denominators are clamped at ``1 - rho_max`` so that gradients stay
    finite slightly beyond the stability boundary; pair with
    :func:`stability_penalty` inside optimization loops.
    """
    lam = node_rates
    rho = lam / moments.mu
    slack = torch.clamp_min(1.0 - rho, 1.0 - rho_max)
    eq = 1.0 / moments.mu + lam * moments.m2 / (2.0 * slack)
    varq = (
        moments.var
        + lam * moments.m3 / (3.0 * slack)
        + lam**2 * moments.m2**2 / (4.0 * slack**2)
    )
    return eq, varq


def stability_penalty(
    node_rates: Tensor,
    moments: ServiceMoments,
    *,
    rho_max: float = RHO_MAX,
    weight: float = 1e4,
) -> Tensor:
    """Smooth penalty pushing Lambda_j back inside the stable region.

    Zero when every queue satisfies rho_j <= rho_max, quadratic outside;
    reduced over the last (node) axis only.
    """
    rho = node_rates / moments.mu
    excess = torch.clamp_min(rho - rho_max, 0.0)
    return weight * torch.sum(excess**2, dim=-1)


def node_arrival_rates(pi: Tensor, lam: Tensor) -> Tensor:
    """Lambda_j = sum_i lambda_i pi_{i,j}; pi is (..., r, m), lam (..., r)."""
    return torch.sum(lam[..., None] * pi, dim=-2)
