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
where the problem's tensors live.

:func:`solve_batch` runs the same loop over a stacked leading (B,) axis of
problems sharing (r, m), where the reference vmaps its ``while_loop``:
each instance stops updating once it is done, its trace is NaN past its
last iteration, and ``iterations`` is per instance. The Fig. 9 baselines
(Oblivious LB, Random CP, Maximum EC) sit at the end of the module.

Not ported yet (ROADMAP.md queue A): the ``debug`` and ``nested`` modes
(the rest of A7) and the problem fields ``objective``, ``geo``, ``cache``,
``cost_weight`` and ``background`` (A6, A17a, A18).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

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
    """Gradient of Eq. (19) linearized at the current point (merged mode).
    A batch's instances are independent, so the gradient of their sum is
    each one's own."""
    with torch.enable_grad():
        p = pi.detach().requires_grad_(True)
        sub_obj = _latency_term(p, z, prob) + prob.theta * _linearized_cost(
            p, p.detach(), prob.cost, beta
        )
        (g,) = torch.autograd.grad(sub_obj.sum(), p)
    return g


def _per_instance(cond: Tensor, like: Tensor) -> Tensor:
    """``cond`` (B...) with trailing unit axes, to select whole instances of
    ``like`` (B..., *event)."""
    return cond.reshape(cond.shape + (1,) * (like.dim() - cond.dim()))


def _select(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(_per_instance(cond, a), a, b)


@torch.no_grad()
def _merged_loop(
    pi: Tensor,
    prob: JLCMProblem,
    mask: Tensor,
    beta: Tensor,
    lr: Tensor,
    eps: Tensor,
    max_iters: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merged-timescale JLCM: the reference's ``_device_merged_loop``.

    Per iteration: linearize the cost surrogate at the current pi, take one
    projected-gradient step, refresh z, and backtrack at two levels
    (lr, lr/4, lr/16) with lr re-growth x1.1 (capped at 16 lr0) on
    acceptance and a 16x shrink on a rejected round. An instance stops on
    the paper's relative tolerance or when its lr collapses.

    ``pi`` is (..., r, m): leading axes index independent instances, each
    carrying its own ``done`` flag that freezes its pi, z, objective and lr
    (the reference's vmapped ``while_loop``). The three step sizes are all
    evaluated and selected on the device with the reference's precedence,
    so the backtracking needs no host sync; the stop test, ``done.all()``,
    costs the loop one host sync per iteration.

    Returns (pi, z, trace, iterations): trace (..., T + 1) over the T
    iterations the loop ran, NaN past each instance's last one; iterations
    (...,) per instance.
    """
    pi = project_capped_simplex(pi, prob.k, mask)
    z = _refresh_z(pi, prob)
    prev = smoothed_objective(pi, z, prob, beta)

    g0 = torch.abs(_merged_grad(pi, z, prob, beta)).amax(dim=(-2, -1))
    lr = lr / torch.clamp_min(g0, 1e-9)  # first step moves ~lr in pi
    lr_cap = lr * 16.0
    trace = [prev]
    done = torch.zeros_like(prev, dtype=torch.bool)
    iterations = torch.zeros_like(prev, dtype=torch.int64)

    def attempt(step: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        p = project_capped_simplex(pi - _per_instance(step, pi) * g, prob.k, mask)
        zz = _refresh_z(p, prob)
        return p, zz, smoothed_objective(p, zz, prob, beta)

    for _ in range(max_iters):
        g = _merged_grad(pi, z, prob, beta)
        first = attempt(lr)
        second = attempt(lr / 4.0)
        third = attempt(lr / 16.0)
        bound = prev + BACKTRACK_SLACK
        take_first = ~(first[2] > bound)
        take_second = ~(second[2] > bound)
        cand = [
            _select(take_first, a, _select(take_second, b, c))
            for a, b, c in zip(first, second, third)
        ]
        accepted = cand[2] <= bound
        active = ~done
        moved = accepted & active
        pi = _select(moved, cand[0], pi)
        z = torch.where(moved, cand[1], z)
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
        prev = torch.where(active, obj, prev)
        lr = torch.where(active, lr_n, lr)
        trace.append(torch.where(active, obj, torch.nan))
        iterations += active
        done = done | collapsed | converged
        if bool(done.all()):  # the one host sync per iteration
            break
    return pi, z, torch.stack(trace, dim=-1), iterations


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
            f"JLCMProblem.{', '.join(extras)} not supported by the PyTorch "
            "port yet (ROADMAP.md queue A: A6, with A17a for geo and A18 "
            "for cost_weight and background)"
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


def _run(
    prob: JLCMProblem,
    mask: Tensor,
    pi0: Tensor | None,
    *,
    beta: float,
    lr: float,
    eps: float,
    max_iters: int,
) -> JLCMSolution:
    """Start from ``pi0`` (broadcast to ``mask``'s shape) or the feasible
    uniform point, run the merged loop and read the solution."""
    device = mask.device
    if pi0 is None:
        pi = feasible_uniform(mask, prob.k)
    else:
        pi = torch.as_tensor(pi0, dtype=torch.float32, device=device).expand(mask.shape)
    pi = project_capped_simplex(pi, prob.k, mask)
    scalar = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    pi, z, trace, iters = _merged_loop(
        pi, prob, mask, scalar(beta), scalar(lr), scalar(eps), max_iters
    )
    with torch.no_grad():
        sol = _finalize(pi, z, prob, trace)
    return sol._replace(iterations=iters)


def _check_pi0(pi0, device: torch.device, shapes: tuple, message: str) -> None:
    if pi0 is None:
        return
    if isinstance(pi0, Tensor) and pi0.device != device:
        raise ValueError(f"pi0 is on {pi0.device}, the problem on {device}")
    shape = tuple(torch.as_tensor(pi0).shape)
    if shape not in shapes:
        raise ValueError(f"pi0 shape {shape} {message}")


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
            f"mode={mode!r} is not ported yet "
            "(ROADMAP.md queue A: the rest of A7, with A6)"
        )
    if mode != "merged":
        raise ValueError(f"unknown mode {mode!r}")
    prob = _as_problem(prob)
    device = prob.lam.device
    if prob.mask is None:
        mask = torch.ones((prob.r, prob.m), dtype=torch.bool, device=device)
    else:
        mask = prob.mask
    _check_pi0(pi0, device, (tuple(mask.shape),),
               f"does not match the problem's (r, m) = {tuple(mask.shape)}")
    return _run(prob, mask, pi0, beta=beta, lr=lr, eps=eps, max_iters=max_iters)


# ---------------------------------------------------------------------------
# Batched solving: a stacked leading axis of problems in one loop.
# ---------------------------------------------------------------------------


def stack_problems(probs: Sequence[JLCMProblem]) -> JLCMProblem:
    """Stack problems sharing (r, m) along a new leading axis.

    ``lam``, ``k``, ``theta``, ``cost``, ``moments`` and ``mask`` may vary
    per problem; a ``mask`` of ones stands in where a problem has
    ``mask=None`` (all placements allowed). Every field is cast to float32
    (``mask`` to bool) on the problems' one device.
    """
    probs = [_as_problem(p) for p in probs]
    if not probs:
        raise ValueError("stack_problems needs at least one problem")
    r, m = probs[0].r, probs[0].m
    device = probs[0].lam.device
    for p in probs:
        if (p.r, p.m) != (r, m):
            raise ValueError(
                f"all problems must share (r, m): got {(p.r, p.m)} vs {(r, m)}"
            )
        if p.lam.device != device:
            raise ValueError(
                f"all problems must share one device: got {p.lam.device} vs {device}"
            )
    ones = torch.ones((r, m), dtype=torch.bool, device=device)
    stack = lambda xs: torch.stack(list(xs))
    return JLCMProblem(
        lam=stack(p.lam for p in probs),
        k=stack(p.k for p in probs),
        moments=ServiceMoments(*(stack(p.moments[i] for p in probs) for i in range(3))),
        cost=stack(p.cost for p in probs),
        theta=stack(p.theta for p in probs),
        mask=stack(ones if p.mask is None else p.mask for p in probs),
    )


def solve_batch(
    probs: Sequence[JLCMProblem] | JLCMProblem,
    *,
    beta: float = 1e3,
    max_iters: int = 300,
    lr: float = 0.1,
    eps: float = 1e-5,
    pi0: Tensor | None = None,
) -> JLCMSolution:
    """Solve a batch of JLCM instances in one loop over a leading (B,) axis.

    ``probs`` is a sequence of :class:`JLCMProblem` sharing (r, m) (stacked
    here by :func:`stack_problems`) or an already-stacked problem with an
    explicit ``mask``. ``pi0`` is one start per instance (B, r, m) or a
    start shared by all (r, m). Every field of the result has the leading
    (B,) axis; ``objective_trace`` is (B, max_iters + 1), NaN past each
    instance's last iteration, and ``iterations`` (B,) counts each
    instance's own. Each instance takes the steps :func:`solve` takes on
    it alone.
    """
    if isinstance(probs, JLCMProblem):
        if probs.mask is None:
            raise ValueError("stacked problems must carry an explicit mask")
        stacked = _as_problem(probs)
    else:
        stacked = stack_problems(probs)
    mask = stacked.mask
    _check_pi0(pi0, mask.device, (tuple(mask.shape), tuple(mask.shape[1:])),
               f"matches neither the stacked batch {tuple(mask.shape)} nor a "
               f"shared per-instance start {tuple(mask.shape[1:])}")
    sol = _run(stacked, mask, pi0, beta=beta, lr=lr, eps=eps, max_iters=max_iters)
    trace = sol.objective_trace
    pad = max_iters + 1 - trace.shape[-1]
    trace = torch.cat([trace, trace.new_full(trace.shape[:-1] + (pad,), torch.nan)], -1)
    return sol._replace(objective_trace=trace)


# ---------------------------------------------------------------------------
# Oblivious baselines of §V.B Fig. 9.
# ---------------------------------------------------------------------------


def proportional_lb_pi(mask: Tensor, k, moments: ServiceMoments) -> Tensor:
    """'Oblivious LB': dispatch proportional to the service rates on a given
    placement, then projected onto the feasible polytope.

    ``mask`` (..., r, m) with ``k`` (r,) or (..., r) and moments of (m,):
    leading axes are a batch (Random CP scores its candidate placements in
    one call).
    """
    mask = mask.bool()
    k = torch.as_tensor(k, dtype=torch.float32, device=mask.device)
    w = torch.where(mask, moments.mu[..., None, :], 0.0)
    pi = k[..., None] * w / torch.sum(w, dim=-1, keepdim=True)
    return project_capped_simplex(pi, k, mask)


def random_placement_mask(u: Tensor, n) -> Tensor:
    """'Random CP': each file i places its n_i chunks on nodes drawn
    uniformly at random.

    ``u`` (..., r, m) holds U[0, 1) draws where the reference takes a key:
    ``perm = argsort(u)`` is a uniform random permutation per file, and
    ``mask[i, perm[i, j]] = j < n_i``. Returns a bool (..., r, m) mask.
    """
    perm = torch.argsort(u, dim=-1, stable=True)
    n = torch.as_tensor(n, device=u.device)
    take = torch.arange(u.shape[-1], device=u.device) < n[..., None]
    placed = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    return placed.scatter_(-1, perm, take.expand(perm.shape))


def max_ec_problem(prob: JLCMProblem) -> JLCMProblem:
    """Maximum EC's solver problem: theta = 0 and every placement allowed,
    so the optimizer never prunes a node."""
    prob = _as_problem(prob)
    return prob._replace(
        theta=torch.zeros_like(prob.theta),
        mask=torch.ones((prob.r, prob.m), dtype=torch.bool, device=prob.lam.device),
    )


def max_ec_report(prob: JLCMProblem, sol: JLCMSolution) -> JLCMSolution:
    """Maximum EC's solution from ``sol``, a solve of
    :func:`max_ec_problem` (alone or as one instance of a batch): n_i = m
    for every file, the full placement's cost at the problem's theta."""
    prob = _as_problem(prob)
    cost = torch.sum(prob.cost.expand(prob.r, prob.m))
    return sol._replace(
        cost=cost,
        objective=sol.latency + prob.theta * cost,
        n=torch.full((prob.r,), prob.m, dtype=torch.int64, device=cost.device),
        placement=torch.ones((prob.r, prob.m), dtype=torch.bool, device=cost.device),
    )


def max_ec_solution(prob: JLCMProblem, **kw) -> JLCMSolution:
    """'Maximum EC': n_i = m (all nodes), scheduling optimized only: JLCM
    at theta = 0 on the full support, then costed in full."""
    return max_ec_report(prob, solve(max_ec_problem(prob), **kw))
