"""Algorithm JLCM (paper §IV): joint latency + storage-cost minimization.

Problem JLCM (Eq. 9-14) minimizes, over dispatch probabilities pi (r, m)
and the auxiliary z,

  z + sum_j Lambda_j/(2 lam_hat) [X_j + sqrt(X_j^2 + Y_j)]
    + theta * sum_i sum_j V_j 1(pi_ij > 0)

subject to Theorem-1 feasibility (capped simplex per file). Placement S_i
and code length n_i are read from the support of pi (Lemma 4).

The cost indicator is handled as in the paper: the log-smoothed surrogate
V_j log(beta pi + 1)/log(beta) (Eq. 20), linearized around the current
point (Eq. 17); gradients come from ``torch.autograd``. Three modes, as in
the reference:

  * ``merged``: one loop that linearizes, takes a projected-gradient step,
    refreshes z and backtracks at two levels (the paper's r = 1000 run);
  * ``debug``: the same algorithm with host-side control flow, one probe
    at a time, for step-by-step inspection (``verbose`` prints there);
  * ``nested``: the faithful two-timescale structure (outer
    linearization, ``inner_steps`` of projected gradient descent, then the
    z-minimization step).

The latency term is pluggable (``core/objectives.py``): a problem may
carry an ``ObjectiveSpec`` (tenant classes, weights, tail deadlines), a
``GeoSpec`` (client sites, ``core/geo.py``), a ``CacheSpec`` (hot-tier hit
rates), a ``cost_weight`` (rows that stand for many stored files,
``core/aggregate.py``) and ``background`` node load (rows frozen outside
the problem). Each ``None`` adds no op: the plain problem solves bit for
bit as before.

:func:`solve_batch` runs the merged loop over a stacked leading (B,) axis
of problems sharing (r, m) and structure, where the reference vmaps its
``while_loop``: each instance stops updating once it is done, its trace is
NaN past its last iteration, and ``iterations`` is per instance. The Fig.
9 baselines (Oblivious LB, Random CP, Maximum EC) sit at the end of the
module. Everything runs where the problem's tensors live.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from repro_torch import diag

from .geo import GeoSpec, geo_eq_varq
from .latency_bound import file_latency_bounds
from .objectives import (
    CacheSpec,
    ObjectiveSpec,
    _blend_hits,
    apply_cache_thinning,
    class_mean_bounds,
    class_tail_bounds,
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
    # pluggable objective (core/objectives.py): per-class weighted mean +
    # tail-probability terms; None = the paper's uniform mean, bit for bit
    objective: ObjectiveSpec | None = None
    # geo-aware client fabric (core/geo.py): per-(client-site, node)
    # moments + per-file client mix; build with `geo.geo_problem`, which
    # keeps `moments` the node mixture and collapses C == 1 to geo=None
    geo: GeoSpec | None = None
    # hot/warm cache tier: per-file hit rates thin the warm-tier arrivals
    # to lam_i (1 - h_i), hits blend back in at hit_latency, the hot
    # tier's cost joins the reported cost
    cache: CacheSpec | None = None
    # hierarchical planning (core/aggregate.py): (r,) storage multiplicity
    # of a row that stands for many files
    cost_weight: Tensor | None = None
    # partial re-solves (aggregate.resolve_incremental): (m,) node rates of
    # rows frozen outside this problem, added to the queue utilizations
    # (P-K moments + stability) but never to the fold
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
    # per-class reporting, present iff the problem carried an ObjectiveSpec
    # with weights or deadlines:
    class_latency: Tensor | None = None  # (C,) per-class tight mean bounds
    class_tail: Tensor | None = None  # (C,) per-class P[T_c > d_c] bounds
    iterations: Tensor | None = None  # solver iterations actually run


def _true_cost(
    pi: Tensor, cost: Tensor, tol: float = SUPPORT_TOL, weight: Tensor | None = None
) -> Tensor:
    if weight is None:
        return torch.sum((pi > tol) * cost[..., None, :], dim=(-2, -1))
    body = weight[..., :, None] * (pi > tol) * cost[..., None, :]
    return torch.sum(body, dim=(-2, -1))


def _smoothed_cost(
    pi: Tensor, cost: Tensor, beta: Tensor, weight: Tensor | None = None
) -> Tensor:
    """Eq. (20): sum_ij V_j log(beta pi + 1) / log(beta)."""
    body = cost[..., None, :] * torch.log(beta * pi + 1.0) / torch.log(beta)
    if weight is not None:
        body = weight[..., :, None] * body
    return torch.sum(body, dim=(-2, -1))


def _linearized_cost(
    pi: Tensor,
    pi_ref: Tensor,
    cost: Tensor,
    beta: Tensor,
    weight: Tensor | None = None,
) -> Tensor:
    """Eq. (17): value at ref + gradient of the log surrogate at ref."""
    if weight is None:
        base = torch.sum((pi_ref > 0.0) * cost[..., None, :], dim=(-2, -1))
        slope = cost[..., None, :] / ((pi_ref + 1.0 / beta) * torch.log(beta))
        return base + torch.sum(slope * (pi - pi_ref), dim=(-2, -1))
    w = weight[..., :, None]
    base = torch.sum(w * (pi_ref > 0.0) * cost[..., None, :], dim=(-2, -1))
    slope = w * cost[..., None, :] / ((pi_ref + 1.0 / beta) * torch.log(beta))
    return base + torch.sum(slope * (pi - pi_ref), dim=(-2, -1))


def _latency_term(pi: Tensor, z: Tensor, prob: JLCMProblem) -> Tensor:
    lat = composed_latency(
        pi, z, prob.lam, prob.moments, prob.objective, prob.geo, prob.cache,
        background=prob.background,
    )
    # stability belongs to the queues the warm tier serves: the thinned
    # miss traffic plus any frozen-row background load
    rates = node_arrival_rates(pi, apply_cache_thinning(prob.lam, prob.cache))
    if prob.background is not None:
        rates = rates + prob.background
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
        pi, prob.cost, beta, weight=prob.cost_weight
    )


def _grad_of(sub_obj, pi: Tensor) -> Tensor:
    """Gradient of ``sub_obj`` at ``pi``. A batch's instances are
    independent, so the gradient of their sum is each one's own."""
    with torch.enable_grad():
        p = pi.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sub_obj(p).sum(), p)
    return g


def _merged_grad(pi: Tensor, z: Tensor, prob: JLCMProblem, beta: Tensor) -> Tensor:
    """Gradient of Eq. (19) linearized at the current point (merged mode)."""
    return _grad_of(
        lambda p: _latency_term(p, z, prob) + prob.theta * _linearized_cost(
            p, p.detach(), prob.cost, beta, weight=prob.cost_weight
        ),
        pi,
    )


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
    costs the loop one host sync per iteration. Each iteration's body runs
    under ``diag.hot_path("core.solve_merged")``, the stop test outside it
    (the reference syncs once a solve, after its ``while_loop``).

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
        # the iteration's device body is a guarded hot path; the stop test
        # below, the iteration's one host sync, stays outside it
        with diag.hot_path("core.solve_merged"):
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
    spec = prob.objective
    placement = pi > SUPPORT_TOL
    n = torch.sum(placement, dim=-1)
    lam_eff = apply_cache_thinning(prob.lam, prob.cache)
    if prob.geo is not None:
        # per-(file, node) sojourn moments drop into the (r, m) bound
        eq_b, varq_b = geo_eq_varq(pi, lam_eff, prob.geo)
    else:
        rates = node_arrival_rates(pi, lam_eff)
        if prob.background is not None:
            rates = rates + prob.background
        eq, varq = pk_sojourn_moments(rates, prob.moments)
        eq_b, varq_b = eq[..., None, :], varq[..., None, :]
    t = file_latency_bounds(pi, eq_b, varq_b)
    tight = compose_file_bounds(t, pi, eq_b, varq_b, prob.lam, spec, prob.cache)
    latency = composed_latency(
        pi, z, prob.lam, prob.moments, spec, prob.geo, prob.cache,
        background=prob.background,
    )
    cost = _true_cost(pi, prob.cost, weight=prob.cost_weight)
    if prob.cache is not None:
        cost = cost + prob.cache.hot_cost
    class_latency = class_tail = None
    # per-class reporting needs a class axis some per-class array gives (a
    # spec with none of them reports like the scalar objective)
    if spec is not None and (spec.weight is not None or spec.deadline is not None):
        t_report = t if prob.cache is None else _blend_hits(t, prob.cache)
        class_latency = class_mean_bounds(t_report, prob.lam, spec)
        class_tail = class_tail_bounds(
            pi, eq_b, varq_b, lam_eff, spec,
            lam_total=None if prob.cache is None else prob.lam,
        )
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
        class_latency=class_latency,
        class_tail=class_tail,
    )


def _tensors(x):
    """Every tensor inside a problem field (nested tuples included)."""
    if isinstance(x, Tensor):
        yield x
    elif isinstance(x, tuple):
        for item in x:
            yield from _tensors(item)


def _as_problem(prob: JLCMProblem) -> JLCMProblem:
    """Check the problem's tensors share one device; cast every field to
    float32 there (``mask`` to bool, class ids to int64)."""
    lam = torch.as_tensor(prob.lam, dtype=torch.float32)
    for name, value in zip(prob._fields[1:], prob[1:]):
        for x in _tensors(value):
            if x.device != lam.device:
                raise ValueError(
                    f"JLCMProblem tensors must share one device: lam is on "
                    f"{lam.device}, {name} on {x.device}"
                )
    f32 = lambda x: None if x is None else torch.as_tensor(
        x, dtype=torch.float32, device=lam.device
    )
    spec = prob.objective
    if spec is not None:
        spec = ObjectiveSpec(
            torch.as_tensor(spec.class_id, dtype=torch.int64, device=lam.device),
            *(f32(x) for x in spec[1:]),
        )
    return prob._replace(
        lam=lam,
        k=f32(prob.k),
        moments=ServiceMoments(*(f32(x) for x in prob.moments)),
        cost=f32(prob.cost),
        theta=f32(prob.theta),
        mask=None if prob.mask is None else torch.as_tensor(
            prob.mask, dtype=torch.bool, device=lam.device
        ),
        objective=spec,
        geo=None if prob.geo is None else GeoSpec(*(f32(x) for x in prob.geo)),
        cache=None if prob.cache is None else CacheSpec(*(f32(x) for x in prob.cache)),
        cost_weight=f32(prob.cost_weight),
        background=f32(prob.background),
    )


def _start(prob: JLCMProblem, mask: Tensor, pi0: Tensor | None) -> Tensor:
    """``pi0`` (broadcast to ``mask``'s shape) or the feasible uniform
    point, projected onto the feasible polytope."""
    if pi0 is None:
        pi = feasible_uniform(mask, prob.k)
    else:
        pi = torch.as_tensor(
            pi0, dtype=torch.float32, device=mask.device
        ).expand(mask.shape)
    return project_capped_simplex(pi, prob.k, mask)


def _scalar(x: float, device: torch.device) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


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
    """Run the merged loop from :func:`_start` and read the solution."""
    device = mask.device
    pi, z, trace, iters = _merged_loop(
        _start(prob, mask, pi0), prob, mask, _scalar(beta, device),
        _scalar(lr, device), _scalar(eps, device), max_iters,
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


# ---------------------------------------------------------------------------
# Host-loop paths: `debug` (merged algorithm, Python control flow) and
# `nested` (faithful two-timescale Algorithm JLCM).
# ---------------------------------------------------------------------------


def _inner_pgd(
    pi: Tensor,
    z: Tensor,
    pi_ref: Tensor,
    prob: JLCMProblem,
    mask: Tensor,
    *,
    beta: Tensor,
    inner_steps: int,
    lr: float,
) -> Tensor:
    """Projected gradient descent on Eq. (19) for a fixed reference point,
    step s at ``lr / sqrt(1 + s)``."""
    sub_obj = lambda p: _latency_term(p, z, prob) + prob.theta * _linearized_cost(
        p, pi_ref, prob.cost, beta, weight=prob.cost_weight
    )
    for s in range(inner_steps):
        g = _grad_of(sub_obj, pi)
        step_lr = lr / torch.sqrt(_scalar(1.0 + s, pi.device))
        pi = project_capped_simplex(pi - step_lr * g, prob.k, mask)
    return pi


def _merged_step(
    pi: Tensor, z: Tensor, g: Tensor, prob: JLCMProblem, mask: Tensor, lr: Tensor,
    beta: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """One merged-timescale update along the gradient ``g`` at (pi, z): one
    projected step, then refresh z."""
    pi = project_capped_simplex(pi - lr * g, prob.k, mask)
    z = _refresh_z(pi, prob)
    return pi, z, smoothed_objective(pi, z, prob, beta)


@torch.no_grad()
def _solve_host_loop(
    prob: JLCMProblem,
    pi: Tensor,
    mask: Tensor,
    *,
    beta: float,
    mode: str,
    max_iters: int,
    inner_steps: int,
    lr: float,
    eps: float,
    verbose: bool,
) -> JLCMSolution:
    """The reference's ``_solve_host_loop``: every probe and stop test is
    a host decision."""
    device = mask.device
    beta_t = _scalar(beta, device)
    z = _refresh_z(pi, prob)
    prev = smoothed_objective(pi, z, prob, beta_t)
    trace = [float(prev)]
    lr0 = lr_cap = None  # calibrated on the first step from the gradient scale
    for t in range(max_iters):
        if mode == "debug":
            g = _merged_grad(pi, z, prob, beta_t)
            if lr0 is None:
                lr0 = lr / max(float(torch.abs(g).amax()), 1e-9)  # moves ~lr in pi
                lr_cap = lr0 * 16
            for probe in (lr0, lr0 / 4, lr0 / 16):  # two-level backtracking
                cand = _merged_step(pi, z, g, prob, mask, _scalar(probe, device), beta_t)
                if not float(cand[2]) > float(prev) + BACKTRACK_SLACK:
                    break
            if float(cand[2]) > float(prev) + BACKTRACK_SLACK:  # persistent
                lr0 /= 16.0  # the merged loop's probe-grid shrink
                obj = prev
                if lr0 > lr_cap * 1e-6:
                    trace.append(float(obj))
                    continue  # stalled step: shrink and retry, don't stop
            else:
                pi, z, obj = cand
                lr0 = min(lr0 * 1.1, lr_cap)  # adaptive re-growth
        else:  # nested
            pi = _inner_pgd(
                pi, z, pi, prob, mask, beta=beta_t, inner_steps=inner_steps, lr=lr
            )
            z = _refresh_z(pi, prob)
            obj = smoothed_objective(pi, z, prob, beta_t)
        trace.append(float(obj))
        if verbose and t % 20 == 0:
            print(f"[jlcm] iter {t:4d} objective {float(obj):.6f}")
        # relative stopping rule (paper: tolerance on normalized objective)
        done = abs(float(prev) - float(obj)) < eps * max(1.0, abs(float(obj)))
        prev = obj
        if done:
            break
    trace_t = torch.tensor(trace, dtype=torch.float32, device=device)
    return _finalize(pi, z, prob, trace_t)._replace(
        iterations=torch.tensor(len(trace) - 1, device=device)
    )


def solve(
    prob: JLCMProblem,
    *,
    beta: float = 1e3,
    mode: str = "merged",
    max_iters: int = 300,
    inner_steps: int = 40,
    lr: float = 0.1,
    eps: float = 1e-5,
    pi0: Tensor | None = None,
    verbose: bool = False,
) -> JLCMSolution:
    """Run Algorithm JLCM where the problem's tensors live.

    ``mode="merged"`` (default) runs the merged loop; ``mode="debug"`` is
    the same algorithm with host-side control flow (``verbose`` prints
    there); ``mode="nested"`` is the paper's two-timescale structure with
    ``inner_steps`` of projected gradient descent per linearization.
    Returns the solution with ``objective_trace`` trimmed to the
    ``iterations + 1`` objectives the loop visited.
    """
    if mode not in ("merged", "debug", "nested"):
        raise ValueError(f"unknown mode {mode!r}")
    if prob.geo is not None and prob.background is not None:
        raise ValueError(
            "background node load is not supported on geo problems: the "
            "per-site sojourn moments have no single node-rate axis to "
            "add it to (solve the geo problem densely instead)"
        )
    prob = _as_problem(prob)
    device = prob.lam.device
    if prob.mask is None:
        mask = torch.ones((prob.r, prob.m), dtype=torch.bool, device=device)
    else:
        mask = prob.mask
    _check_pi0(pi0, device, (tuple(mask.shape),),
               f"does not match the problem's (r, m) = {tuple(mask.shape)}")
    if mode == "merged":
        return _run(prob, mask, pi0, beta=beta, lr=lr, eps=eps, max_iters=max_iters)
    return _solve_host_loop(
        prob, _start(prob, mask, pi0), mask, beta=beta, mode=mode,
        max_iters=max_iters, inner_steps=inner_steps, lr=lr, eps=eps,
        verbose=verbose,
    )


# ---------------------------------------------------------------------------
# Batched solving: a stacked leading axis of problems in one loop.
# ---------------------------------------------------------------------------


def _structure(value) -> object:
    """What two problems' optional field must share to stack: None-ness and
    the shape of each tensor (recursively through a spec)."""
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_structure(v) for v in value)
    return tuple(torch.as_tensor(value).shape)


def stack_problems(probs: Sequence[JLCMProblem]) -> JLCMProblem:
    """Stack problems sharing (r, m) along a new leading axis.

    ``lam``, ``k``, ``theta``, ``cost``, ``moments`` and ``mask`` may vary
    per problem, and so may the values inside the optional fields (class
    weights, deadlines, client mixes, hit rates, cost weights, background
    load); their structure may not: every problem must set the same
    optional fields, with the same shapes (a ``ValueError`` names the first
    that differs). A ``mask`` of ones stands in where a problem has
    ``mask=None``. Every field is cast to float32 (``mask`` to bool, class
    ids to int64) on the problems' one device.
    """
    probs = list(probs)
    if not probs:
        raise ValueError("stack_problems needs at least one problem")
    r, m = probs[0].r, probs[0].m
    for p in probs:
        if (p.r, p.m) != (r, m):
            raise ValueError(
                f"all problems must share (r, m): got {(p.r, p.m)} vs {(r, m)}"
            )
    for field in ("objective", "geo", "cache", "cost_weight", "background"):
        shapes = [_structure(getattr(p, field)) for p in probs]
        if any(x is None for x in shapes) and not all(x is None for x in shapes):
            raise ValueError(
                f"cannot stack problems mixing {field}=None with a value; set "
                f"it on every problem (values may vary) or on none"
            )
        if any(x != shapes[0] for x in shapes):
            raise ValueError(
                f"all problems must share the {field} structure (which "
                f"optional fields are set and their shapes): got {shapes}"
            )
    probs = [_as_problem(p) for p in probs]
    device = probs[0].lam.device
    for p in probs:
        if p.lam.device != device:
            raise ValueError(
                f"all problems must share one device: got {p.lam.device} vs {device}"
            )
    ones = torch.ones((r, m), dtype=torch.bool, device=device)
    probs = [p if p.mask is not None else p._replace(mask=ones) for p in probs]

    def stack(values):
        first = values[0]
        if first is None:
            return None
        if isinstance(first, tuple):
            return type(first)(*(stack([v[i] for v in values]) for i in range(len(first))))
        return torch.stack(list(values))

    return JLCMProblem(*(stack([p[i] for p in probs]) for i in range(len(JLCMProblem._fields))))


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
    for every file, the full placement's cost (rows weighted by
    ``cost_weight``) at the problem's theta."""
    prob = _as_problem(prob)
    full_cost = prob.cost.expand(prob.r, prob.m)
    if prob.cost_weight is not None:
        full_cost = prob.cost_weight[:, None] * full_cost
    cost = torch.sum(full_cost)
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
