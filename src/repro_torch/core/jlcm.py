"""Algorithm JLCM (paper §IV): joint latency + storage-cost minimization.

Problem JLCM (Eq. 9-14) minimizes, over dispatch probabilities pi (r, m)
and the auxiliary z,

  z + sum_j Lambda_j/(2 lam_hat) [X_j + sqrt(X_j^2 + Y_j)]
    + theta * sum_i sum_j V_j 1(pi_ij > 0)

subject to Theorem-1 feasibility (capped simplex per file). Placement S_i
and code length n_i are read from the support of pi (Lemma 4).

The cost indicator is handled as in the paper: the log-smoothed surrogate
V_j log(beta pi + 1)/log(beta) (Eq. 20), linearized around the current
point (Eq. 17). This port runs the reference's ``merged`` mode: one loop
that linearizes, takes a projected-gradient step (gradients from
``torch.autograd``), refreshes z, and backtracks at two levels. It runs
where the problem's tensors live. ``solve_batch`` and the ``debug`` and
``nested`` modes are not ported yet (ROADMAP.md queue A, step 7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .latency_bound import file_latency_bounds
from .objectives import (
    apply_cache_thinning,
    compose_file_bounds,
    composed_latency,
    refresh_shared_z,
)
from .projection import feasible_uniform, project_capped_simplex
from .queueing import (
    ServiceMoments,
    node_arrival_rates,
    pk_sojourn_moments,
    stability_penalty,
)

SUPPORT_TOL = 1e-3  # pi below this counts as "not placed" when reading S_i
BACKTRACK_SLACK = 1e-9  # accept a step iff obj <= prev + this


class JLCMProblem(NamedTuple):
    lam: Tensor  # (r,) request arrival rates
    k: Tensor  # (r,) MDS k_i per file
    moments: ServiceMoments  # per-node service moments, tensors of (m,)
    cost: Tensor  # (m,) per-chunk storage price V_j
    theta: float | Tensor  # tradeoff factor (sec/dollar)
    mask: Tensor | None = None  # (r, m) optional allowed-placement support
    # Extensions of the reference that this port does not carry yet; a
    # value other than None raises NotImplementedError in `solve`.
    objective: object | None = None
    geo: object | None = None
    cache: object | None = None
    cost_weight: Tensor | None = None
    background: Tensor | None = None

    @property
    def r(self) -> int:
        return self.lam.shape[-1]

    @property
    def m(self) -> int:
        return self.cost.shape[-1]


class JLCMSolution(NamedTuple):
    pi: Tensor  # (r, m) dispatch probabilities
    z: Tensor  # shared auxiliary variable at optimum
    objective: Tensor  # latency + theta * true (indicator) cost
    latency: Tensor  # shared-z latency objective value
    latency_tight: Tensor  # per-file-z objective (reporting)
    cost: Tensor  # true storage cost sum_i sum_{S_i} V_j
    n: Tensor  # (r,) chosen code lengths n_i
    placement: Tensor  # (r, m) boolean S_i
    objective_trace: Tensor  # per-iteration smoothed objective (monitoring)
    class_latency: Tensor | None = None  # per-class reporting: not ported
    class_tail: Tensor | None = None
    iterations: Tensor | None = None  # solver iterations actually run


def _true_cost(pi: Tensor, cost: Tensor, tol: float = SUPPORT_TOL) -> Tensor:
    return torch.sum((pi > tol) * cost[..., None, :], dim=(-2, -1))


def _smoothed_cost(pi: Tensor, cost: Tensor, beta: Tensor) -> Tensor:
    """Eq. (20): sum_ij V_j log(beta pi + 1) / log(beta)."""
    body = cost[..., None, :] * torch.log(beta * pi + 1.0) / torch.log(beta)
    return torch.sum(body, dim=(-2, -1))


def _linearized_cost(
    pi: Tensor, pi_ref: Tensor, cost: Tensor, beta: Tensor
) -> Tensor:
    """Eq. (17): value at ref + gradient of the log surrogate at ref."""
    base = torch.sum((pi_ref > 0.0) * cost[..., None, :], dim=(-2, -1))
    slope = cost[..., None, :] / ((pi_ref + 1.0 / beta) * torch.log(beta))
    return base + torch.sum(slope * (pi - pi_ref), dim=(-2, -1))


def _latency_term(pi: Tensor, z: Tensor, prob: JLCMProblem) -> Tensor:
    lat = composed_latency(
        pi, z, prob.lam, prob.moments, prob.objective, prob.geo, prob.cache,
        background=prob.background,
    )
    rates = node_arrival_rates(pi, apply_cache_thinning(prob.lam, prob.cache))
    return lat + stability_penalty(rates, prob.moments)


def _refresh_z(pi: Tensor, prob: JLCMProblem) -> Tensor:
    return refresh_shared_z(
        pi, prob.lam, prob.moments, prob.objective, prob.geo, prob.cache,
        background=prob.background,
    )


def smoothed_objective(
    pi: Tensor, z: Tensor, prob: JLCMProblem, beta: Tensor
) -> Tensor:
    """Descent-monitored objective z + sum_j F(Lambda_j) + theta*C_hat (Thm 2)."""
    return _latency_term(pi, z, prob) + prob.theta * _smoothed_cost(
        pi, prob.cost, beta
    )


def _merged_grad(pi: Tensor, z: Tensor, prob: JLCMProblem, beta: Tensor) -> Tensor:
    """Gradient of Eq. (19) linearized at the current point (merged mode)."""
    with torch.enable_grad():
        p = pi.detach().requires_grad_(True)
        sub_obj = _latency_term(p, z, prob) + prob.theta * _linearized_cost(
            p, p.detach(), prob.cost, beta
        )
        (g,) = torch.autograd.grad(sub_obj, p)
    return g


@torch.no_grad()
def _merged_loop(
    pi: Tensor,
    prob: JLCMProblem,
    mask: Tensor,
    beta: Tensor,
    lr: Tensor,
    eps: Tensor,
    max_iters: int,
) -> tuple[Tensor, Tensor, Tensor, int]:
    """Merged-timescale JLCM: the reference's ``_device_merged_loop``.

    Per iteration: linearize the cost surrogate at the current pi, take one
    projected-gradient step, refresh z, and backtrack at two levels
    (lr, lr/4, lr/16) with lr re-growth x1.1 (capped at 16 lr0) on
    acceptance and a 16x shrink on a rejected round. Stops on the paper's
    relative tolerance or when lr collapses.

    The three step sizes are all evaluated and selected on the device with
    the reference's precedence, so the backtracking needs no host sync;
    the stop test costs the loop one host sync per iteration.

    Returns (pi, z, trace, iterations).
    """
    pi = project_capped_simplex(pi, prob.k, mask)
    z = _refresh_z(pi, prob)
    prev = smoothed_objective(pi, z, prob, beta)

    g0 = torch.amax(torch.abs(_merged_grad(pi, z, prob, beta)))
    lr = lr / torch.clamp_min(g0, 1e-9)  # first step moves ~lr in pi
    lr_cap = lr * 16.0
    trace = [prev]

    def attempt(step: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        p = project_capped_simplex(pi - step, prob.k, mask)
        zz = _refresh_z(p, prob)
        return p, zz, smoothed_objective(p, zz, prob, beta)

    iters = 0
    while iters < max_iters:
        g = _merged_grad(pi, z, prob, beta)
        first = attempt(lr * g)
        second = attempt(lr / 4.0 * g)
        third = attempt(lr / 16.0 * g)
        bound = prev + BACKTRACK_SLACK
        take_first = ~(first[2] > bound)
        take_second = ~(second[2] > bound)
        cand = [
            torch.where(take_first, a, torch.where(take_second, b, c))
            for a, b, c in zip(first, second, third)
        ]
        accepted = cand[2] <= bound
        pi = torch.where(accepted, cand[0], pi)
        z = torch.where(accepted, cand[1], z)
        obj = torch.where(accepted, cand[2], prev)  # stalled step keeps prev
        # a rejected round already probed {lr, lr/4, lr/16}, so shrinking
        # 16x continues the geometric /4 probe grid with nothing skipped
        lr_n = torch.where(accepted, torch.minimum(lr * 1.1, lr_cap), lr / 16.0)
        collapsed = ~accepted & (lr_n <= lr_cap * 1e-6)
        # relative stopping rule; a rejected step only stops once lr has
        # collapsed, otherwise it shrinks lr and retries
        converged = accepted & (
            torch.abs(prev - obj) < eps * torch.clamp_min(torch.abs(obj), 1.0)
        )
        prev, lr = obj, lr_n
        trace.append(obj)
        iters += 1
        if bool(collapsed | converged):  # the one host sync per iteration
            break
    return pi, z, torch.stack(trace), iters


def _finalize(pi: Tensor, z: Tensor, prob: JLCMProblem, trace: Tensor) -> JLCMSolution:
    """Read the solution (Lemma 4 support extraction + reporting bounds)."""
    placement = pi > SUPPORT_TOL
    n = torch.sum(placement, dim=-1)
    rates = node_arrival_rates(pi, apply_cache_thinning(prob.lam, prob.cache))
    eq, varq = pk_sojourn_moments(rates, prob.moments)
    eq_b, varq_b = eq[..., None, :], varq[..., None, :]
    t = file_latency_bounds(pi, eq_b, varq_b)
    tight = compose_file_bounds(
        t, pi, eq_b, varq_b, prob.lam, prob.objective, prob.cache
    )
    latency = composed_latency(
        pi, z, prob.lam, prob.moments, prob.objective, prob.geo, prob.cache,
        background=prob.background,
    )
    cost = _true_cost(pi, prob.cost)
    return JLCMSolution(
        pi=pi,
        z=z,
        objective=latency + prob.theta * cost,
        latency=latency,
        latency_tight=tight,
        cost=cost,
        n=n,
        placement=placement,
        objective_trace=trace,
    )


def _as_problem(prob: JLCMProblem) -> JLCMProblem:
    """Check the problem is one this port solves; cast it to float32."""
    extras = [
        name
        for name in ("objective", "geo", "cache", "cost_weight", "background")
        if getattr(prob, name) is not None
    ]
    if extras:
        raise NotImplementedError(
            f"JLCMProblem.{', '.join(extras)} not supported by the "
            "PyTorch port yet (ROADMAP.md, queue A step 7)"
        )
    lam = torch.as_tensor(prob.lam, dtype=torch.float32)
    fields = {
        "k": prob.k, "cost": prob.cost, "theta": prob.theta, "mask": prob.mask,
        "mu": prob.moments.mu, "m2": prob.moments.m2, "m3": prob.moments.m3,
    }
    for name, x in fields.items():
        if isinstance(x, Tensor) and x.device != lam.device:
            raise ValueError(
                f"JLCMProblem tensors must share one device: lam is on "
                f"{lam.device}, {name} on {x.device}"
            )
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=lam.device)
    return prob._replace(
        lam=lam,
        k=f32(prob.k),
        moments=ServiceMoments(*(f32(x) for x in prob.moments)),
        cost=f32(prob.cost),
        theta=f32(prob.theta),
        mask=None if prob.mask is None else torch.as_tensor(
            prob.mask, dtype=torch.bool, device=lam.device
        ),
    )


def solve(
    prob: JLCMProblem,
    *,
    beta: float = 1e3,
    mode: str = "merged",
    max_iters: int = 300,
    lr: float = 0.1,
    eps: float = 1e-5,
    pi0: Tensor | None = None,
) -> JLCMSolution:
    """Run Algorithm JLCM (merged mode) where the problem's tensors live.

    Returns the solution with ``objective_trace`` trimmed to the
    ``iterations + 1`` objectives the loop visited.
    """
    if mode in ("debug", "nested"):
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP.md, queue A step 7)"
        )
    if mode != "merged":
        raise ValueError(f"unknown mode {mode!r}")
    prob = _as_problem(prob)
    device = prob.lam.device
    if prob.mask is None:
        mask = torch.ones((prob.r, prob.m), dtype=torch.bool, device=device)
    else:
        mask = prob.mask
    if pi0 is None:
        pi = feasible_uniform(mask, prob.k)
    else:
        if isinstance(pi0, Tensor) and pi0.device != device:
            raise ValueError(f"pi0 is on {pi0.device}, the problem on {device}")
        pi = torch.as_tensor(pi0, dtype=torch.float32, device=device)
        if pi.shape != mask.shape:
            raise ValueError(
                f"pi0 shape {tuple(pi.shape)} does not match the problem's "
                f"(r, m) = {tuple(mask.shape)}"
            )
    pi = project_capped_simplex(pi, prob.k, mask)
    scalar = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    pi, z, trace, iters = _merged_loop(
        pi, prob, mask, scalar(beta), scalar(lr), scalar(eps), max_iters
    )
    with torch.no_grad():
        sol = _finalize(pi, z, prob, trace)
    return sol._replace(iterations=torch.tensor(iters, device=device))
