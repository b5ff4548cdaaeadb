"""Probabilistic-scheduling request router and the closed loop's control plane.

The port of ``repro/serving/router.py``. Inference replicas play the role
of storage nodes; request classes are the paper's files with k_i = 1. JLCM
tunes the dispatch probabilities pi to minimize mean latency + theta *
replica cost; the router then dispatches every request with Theorem-1
exact marginals (Madow sampling). Hedged dispatch sends a request to
1 + hedge distinct replicas and takes the first completion
(:func:`simulate_serving`, on kernel B1).

Closed-loop control: :class:`EwmaMomentEstimator` folds per-segment node
observations into EWMA estimates of the Lemma-3 moments and
:class:`EwmaRateEstimator` tracks per-class arrival rates (both host
float64 numpy, as in the reference). :class:`AdaptiveReplanner` re-solves
JLCM from those estimates, every candidate (theta x availability mask x
warm/cold start) in one ``solve_batch``, and arbitrates the candidates by
rollouts from the live queue state: :func:`batched_rollout_scores` runs
every candidate x draw as ONE B1 launch, scores each stream with the
device empirical objective, folds in ``theta * cost`` and takes the argmin
on the device; the caller's ``int(best)`` is the replan's one host sync.
:class:`HierarchicalReplanner` is the million-file variant on
``core/aggregate.py`` and :class:`GeoAdaptiveReplanner` the client-fabric
variant on ``core/geo.py``.

Plans are solved where the tensors live (the pool's, or the estimator
prior's), and plans come back to the host once, as numpy, as in the
reference. Where the reference takes a PRNG key, the port takes a
``torch.Generator`` on the simulated device or explicit draws
(``storage.simulator.SimDraws``, :class:`ServingDraws`), which is how the
tests feed it the reference's own randomness.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch import diag
from repro_torch.core import (
    FactoredPlan,
    Hierarchy,
    JLCMProblem,
    ObjectiveSpec,
    ServiceMoments,
    build_problem,
    empirical_objective,
    empirical_objective_device,
    feasible_uniform,
    fit_shifted_exponential,
    geo_problem,
    madow_sample,
    make_cache_spec,
    materialize,
    project_capped_simplex,
    resolve_incremental,
    solve,
    solve_batch,
)
from repro_torch.kernels.fcfs_queue import fcfs_scan
from repro_torch.storage.cache import che_hit_rates
from repro_torch.storage.repair import augment_plan
from repro_torch.storage.simulator import (
    SimDraws,
    generate_workload,
    run_geo_segment_batch,
    run_geo_segment_raw,
    run_segment_batch,
    run_segment_raw,
    segment_draws,
)


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, Tensor) else x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ReplicaPool:
    moments: ServiceMoments  # per-replica service moments (measured/EWMA)
    cost: Tensor  # per-replica provisioning cost

    @property
    def m(self) -> int:
        return int(self.cost.shape[0])

    def rates(self, class_rates) -> Tensor:
        """``class_rates`` as float32 on the pool's device."""
        return torch.as_tensor(_host(class_rates), dtype=torch.float32, device=self.cost.device)


@dataclasses.dataclass
class Router:
    pool: ReplicaPool
    pi: np.ndarray  # (r, m) dispatch probabilities per request class
    hedge: int = 0  # extra replicas per request (first-wins)
    latency_bound: float = float("nan")
    # replica id -> (pi, latency_bound) re-plan with that replica removed,
    # precomputed in one batched solve (see precompute_failover)
    failover: dict[int, tuple[np.ndarray, float]] = dataclasses.field(default_factory=dict)
    # (class_rates, theta) the failover table was computed for; drop_replica
    # only consults the table when called with matching conditions
    failover_inputs: tuple[np.ndarray, float] | None = None

    @classmethod
    def plan(
        cls,
        pool: ReplicaPool,
        class_rates,
        *,
        theta: float = 0.0,
        hedge: int = 0,
        max_iters: int = 200,
    ) -> "Router":
        lam = pool.rates(class_rates)
        prob = JLCMProblem(
            lam=lam, k=torch.ones_like(lam), moments=pool.moments, cost=pool.cost, theta=theta
        )
        sol = solve(prob, max_iters=max_iters)
        return cls(
            pool=pool,
            pi=sol.pi.cpu().numpy(),
            hedge=hedge,
            latency_bound=float(sol.latency_tight),
        )

    def route(
        self,
        class_id: int,
        *,
        generator: torch.Generator | None = None,
        u: float | None = None,
    ) -> list[int]:
        """Replica ids for one request (1 + hedge distinct replicas).

        The Madow uniform is ``u`` if given, else one draw from
        ``generator`` (on the host)."""
        if u is None:
            u = float(torch.rand((), generator=generator))
        pi = torch.from_numpy(np.asarray(self.pi[class_id], np.float32))
        if self.hedge > 0:
            kk = 1 + self.hedge
            pi = project_capped_simplex(pi[None] * kk, torch.tensor([float(kk)]))[0]
        mask = madow_sample(torch.tensor(u, dtype=torch.float32), pi)
        return [int(j) for j in np.flatnonzero(mask.numpy())]

    @classmethod
    def plan_sweep(
        cls,
        pool: ReplicaPool,
        class_rates,
        thetas,
        *,
        hedge: int = 0,
        max_iters: int = 200,
    ) -> list["Router"]:
        """Plan one router per tradeoff factor: the whole theta sweep is a
        single batched solve (pick the cheapest plan meeting an SLA
        downstream)."""
        lam = pool.rates(class_rates)
        probs = [
            JLCMProblem(lam=lam, k=torch.ones_like(lam), moments=pool.moments,
                        cost=pool.cost, theta=float(theta))
            for theta in thetas
        ]
        sols = solve_batch(probs, max_iters=max_iters)
        # ONE materialization for the whole sweep
        pi_np = sols.pi.cpu().numpy()
        lat_np = sols.latency_tight.cpu().numpy()
        return [
            cls(pool=pool, pi=pi_np[i], hedge=hedge, latency_bound=float(lat_np[i]))
            for i in range(len(probs))
        ]

    def _masked_problem(self, dead: list[int], class_rates, theta) -> JLCMProblem:
        lam = self.pool.rates(class_rates)
        mask = torch.ones((self.pi.shape[0], self.pool.m), dtype=torch.bool, device=lam.device)
        mask[:, dead] = False
        return JLCMProblem(
            lam=lam, k=torch.ones_like(lam), moments=self.pool.moments, cost=self.pool.cost,
            theta=theta, mask=mask,
        )

    def precompute_failover(
        self, class_rates, theta: float = 0.0, *, max_iters: int = 150
    ) -> "Router":
        """Re-optimize dispatch for EVERY possible single-replica failure in
        one ``solve_batch`` call (m masked problems), so a later
        :meth:`drop_replica` is a dictionary lookup instead of a solve."""
        probs = [self._masked_problem([j], class_rates, theta) for j in range(self.pool.m)]
        sols = solve_batch(probs, max_iters=max_iters)
        # ONE materialization for all m failure plans
        pi_np = sols.pi.cpu().numpy()
        lat_np = sols.latency_tight.cpu().numpy()
        failover = {j: (pi_np[j], float(lat_np[j])) for j in range(self.pool.m)}
        return dataclasses.replace(
            self,
            failover=failover,
            failover_inputs=(_host(class_rates).copy(), float(theta)),
        )

    def drop_replica(self, replica: int, class_rates, theta: float = 0.0) -> "Router":
        """Elastic scale-down / failure: mask the replica and re-plan.

        Uses the precomputed failover table only when it was computed for
        the same ``class_rates``/``theta`` (see :meth:`precompute_failover`);
        a stale table is ignored and the masked problem is solved now."""
        if replica in self.failover and self.failover_inputs is not None:
            rates0, theta0 = self.failover_inputs
            if theta0 == float(theta) and np.allclose(rates0, _host(class_rates)):
                pi, bound = self.failover[replica]
                return dataclasses.replace(
                    self, pi=pi, latency_bound=bound, failover={}, failover_inputs=None,
                )
        sol = solve(self._masked_problem([replica], class_rates, theta), max_iters=150)
        return dataclasses.replace(
            self,
            pi=sol.pi.cpu().numpy(),
            latency_bound=float(sol.latency_tight),
            failover={},
            failover_inputs=None,
        )


# ---------------------------------------------------------------------------
# Closed-loop control: measured state in, batched re-plans out.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EwmaMomentEstimator:
    """EWMA tracker of per-node service moments from segment observations.

    Each :meth:`update` consumes one segment's ``NodeObservations`` (counts
    and raw power sums of observed service times), forms the segment's
    unbiased raw-moment estimates, and blends them into exponentially
    weighted running estimates of E[X_j], E[X_j^2], E[X_j^3], the inputs
    Lemma 3's P-K formulas need. Nodes with no observation this segment
    (down, or no dispatch mass) keep their previous estimate. ``prior``
    seeds the estimates, so :meth:`moments` is total. The state is host
    float64 numpy; :meth:`moments` returns float32 tensors on the device of
    the prior's tensors. The estimator is elementwise, so a (C, m) prior
    (a geo fabric's per-pair moments) tracks the whole pair family.
    """

    prior: ServiceMoments
    alpha: float = 0.35
    m1: np.ndarray = dataclasses.field(init=False)
    m2: np.ndarray = dataclasses.field(init=False)
    m3: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.m1 = _host(self.prior.mean).astype(float)
        self.m2 = _host(self.prior.m2).astype(float)
        self.m3 = _host(self.prior.m3).astype(float)

    def update(self, obs: Any) -> ServiceMoments:
        count = _host(obs.count).astype(float)
        seen = count > 0
        safe = np.maximum(count, 1.0)
        h1 = _host(obs.s1).astype(float) / safe
        h2 = _host(obs.s2).astype(float) / safe
        h3 = _host(obs.s3).astype(float) / safe
        a = self.alpha
        self.m1 = np.where(seen, (1 - a) * self.m1 + a * h1, self.m1)
        self.m2 = np.where(seen, (1 - a) * self.m2 + a * h2, self.m2)
        self.m3 = np.where(seen, (1 - a) * self.m3 + a * h3, self.m3)
        return self.moments()

    def moments(self) -> ServiceMoments:
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.prior.mu.device)
        return ServiceMoments(mu=f32(1.0 / self.m1), m2=f32(self.m2), m3=f32(self.m3))

    def fitted_shifted_exp(self) -> tuple[np.ndarray, np.ndarray]:
        """Method-of-moments fit of the cluster's service family D + Exp:
        per-node ``(overheads D_j, exp rates 1/s_j)`` matching the estimated
        first two moments (``core.queueing.fit_shifted_exponential``), as
        float32 numpy. The replanners sample their rollouts' service times
        from it, never from the simulator's ground truth."""
        d, rate = fit_shifted_exponential(self.m1, self.m2)
        return d.numpy(), rate.numpy()


@dataclasses.dataclass
class EwmaRateEstimator:
    """EWMA of per-class (per-file) arrival rates from observed traffic.

    :meth:`update` takes the request class ids seen in one segment and the
    segment's duration; the empirical rates ``n_i / duration`` are
    EWMA-blended so flash crowds and diurnal ramps reach the replanner's
    lambda within ``~1/alpha`` segments.
    """

    prior: np.ndarray
    alpha: float = 0.5
    rates: np.ndarray = dataclasses.field(init=False)
    dropped: int = dataclasses.field(init=False, default=0)

    def __post_init__(self) -> None:
        self.rates = _host(self.prior).astype(float)

    def update(self, class_id: Any, duration: float) -> np.ndarray:
        """Fold one segment's observed class ids into the EWMA rates.

        Ids outside ``[0, r)`` are not client classes (repair pseudo-file
        rows ride at ids >= r); they are dropped and counted in
        :attr:`dropped`, never clamped onto a real class.
        """
        ids = _host(class_id).ravel()
        r = self.rates.shape[0]
        valid = (ids >= 0) & (ids < r)
        self.dropped += int(ids.size - valid.sum())
        counts = np.bincount(ids[valid], minlength=r).astype(float)
        emp = counts / max(float(duration), 1e-9)
        self.rates = (1 - self.alpha) * self.rates + self.alpha * emp
        return self.rates.copy()

    def update_misses(self, class_id: Any, hit: Any, duration: float) -> np.ndarray:
        """Cache-tier variant of :meth:`update`: fold in *miss* traffic only,
        the only arrivals the warm tier observes; :attr:`rates` is then a
        miss-rate estimate, which the cache-aware replanner inverts back to
        raw rates through the deployed TTLs."""
        ids = _host(class_id).ravel()
        miss = np.logical_not(_host(hit).astype(bool).ravel())
        return self.update(ids[miss], duration)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (candidate-lane padding)."""
    return 1 << max(0, n - 1).bit_length()


@diag.hot_path("serving.batched_rollout_scores")
def batched_rollout_scores(
    carry,
    generator: torch.Generator | None,
    pi_stack: Tensor,
    lam: Tensor,
    overheads: Tensor,
    rates: Tensor,
    avail: Tensor,
    cost_term: Tensor,
    objective: ObjectiveSpec | None = None,
    *,
    n_clients: int,
    n_requests: int = 600,
    rollout_seeds: int = 1,
    ttl: Tensor | None = None,
    hit_latency: Tensor | float = 0.0,
    devices: str = "auto",
    geo: bool = False,
    draws: SimDraws | None = None,
) -> tuple[Tensor, Tensor]:
    """Score a (B, r, m) candidate-plan stack with ONE B1 launch.

    Every candidate is rolled out from ``carry`` under the same K draws
    (common random numbers; K = ``rollout_seeds`` fresh draws from
    ``generator``, or ``draws`` with a leading (K,) axis), so the B x K
    systems are one launch (``run_segment_batch``, or
    ``run_geo_segment_batch`` with ``geo`` and (C, r) / (C, m) inputs). With
    one draw each candidate's stream is bitwise what ``run_segment_raw``
    gives that plan alone. Each stream is scored by the device empirical
    objective with repair rows (``file_id >= n_clients``) masked out, the
    K scores averaged, ``cost_term`` (B,) added, and the candidate axis
    padded to a power of two with +inf (the padded lanes run nothing), then
    ``argmin``: all on the device. ``devices="auto"`` with several CUDA
    devices splits the (B_pad x K) lanes over them
    (``_batched_rollout_scores_on``); ``"never"`` runs on the one device the
    inputs are on.

    A guarded hot path (``diag.py``): pass every tensor on the rollout's
    device. Returns device tensors ``(scores (B_pad,), best ())``; the
    caller's ``int(best)`` is the replan's one host sync.
    """
    if devices not in ("auto", "never"):
        raise ValueError(f"devices must be 'auto' or 'never', got {devices!r}")
    on = None
    if devices == "auto" and pi_stack.is_cuda and torch.cuda.device_count() > 1:
        on = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return _batched_rollout_scores_on(
        on, carry, generator, pi_stack, lam, overheads, rates, avail, cost_term, objective,
        n_clients=n_clients, n_requests=n_requests, rollout_seeds=rollout_seeds, ttl=ttl,
        hit_latency=hit_latency, geo=geo, draws=draws)


def _lane_pad(b: int, k: int, n_dev: int) -> int | None:
    """The padded candidate count whose B_pad x K lanes divide over
    ``n_dev`` devices: the power of two at or above ``b``, doubled up to 4
    times; None where no such pad divides (the one-device program runs),
    the reference's rule."""
    b_pad = _pow2(b)
    for _ in range(5):
        if (b_pad * k) % n_dev == 0:
            return b_pad
        b_pad *= 2
    return None


def _batched_rollout_scores_on(
    devices, carry, generator, pi_stack, lam, overheads, rates, avail, cost_term,
    objective=None, *, n_clients, n_requests=600, rollout_seeds=1, ttl=None,
    hit_latency=0.0, geo=False, draws=None,
) -> tuple[Tensor, Tensor]:
    """:func:`batched_rollout_scores` with its (candidate x draw) lanes
    split over ``devices`` (a list, or None for the inputs' device alone),
    as the reference's ``shard_map`` over its lanes: the candidate pad grows
    (``_lane_pad``) until the B_pad x K lanes divide the device count, the
    padded candidates replaying candidate 0; the draws, dispatch masks and
    cache pre-scan run once on the inputs' device, each device runs one B1
    launch on its block of lanes, and the lanes' latencies come back to
    the inputs' device, where the objective, the scores and ``argmin`` run
    on the real candidates as on one device. So scores are bitwise the
    one-device program's. Where no pad divides, the one-device program
    runs."""
    if draws is not None and draws.arrival.shape[0] != rollout_seeds:
        raise ValueError(
            f"draws hold {draws.arrival.shape[0]} rollouts, rollout_seeds is {rollout_seeds}")
    b = pi_stack.shape[0]
    dev = pi_stack.device
    b_pad = _pow2(b)
    if devices is not None and len(devices) > 1:
        grown = _lane_pad(b, rollout_seeds, len(devices))
        if grown is None:
            devices = None  # odd device count: the one-device program
        else:
            b_pad = grown
            pi_stack = torch.cat([pi_stack, pi_stack[:1].expand((b_pad - b,) + pi_stack.shape[1:])])
    else:
        devices = None
    if geo:
        res = run_geo_segment_batch(carry, generator, pi_stack, lam, overheads, rates, avail,
                                    n_requests, n_draws=rollout_seeds, draws=draws,
                                    devices=devices)
    else:
        res = run_segment_batch(carry, generator, pi_stack, lam, overheads, rates, avail,
                                n_requests, ttl, hit_latency, n_draws=rollout_seeds, draws=draws,
                                devices=devices)
    lat, fid = res.latency[:b], res.file_id[:b]
    lane = empirical_objective_device(lat, fid, objective, valid=fid < n_clients)  # (B, K)
    scores = torch.mean(lane, dim=1) + torch.as_tensor(cost_term, dtype=torch.float32, device=dev)
    pad = torch.full((b_pad - b,), torch.inf, dtype=torch.float32, device=dev)
    scores = torch.cat([scores, pad])
    return scores, torch.argmin(scores)


def _rollout_draws(generator, draws, lam_cs: Tensor, n_requests: int, m: int, k: int):
    """One set of (K, N) rollout draws, shared by every candidate (and by
    the sequential loop's calls): ``draws`` as given, or a callable's draws
    at the planned rates ``lam_cs`` (C, r), or fresh from ``generator``."""
    if callable(draws):
        return draws(lam_cs)
    return draws if draws is not None else segment_draws(generator, lam_cs, n_requests, m, k)


def _arbitrate(rp, sols, n_probs: int, rollout, sequential_one) -> int:
    """Candidate arbitration shared by the replanners: the batched device
    argmin (``rollout``) or the sequential loop (``sequential_one(i)`` gives
    candidate i's host latency stream and file ids); scores and walls land
    in ``rp``'s telemetry. Returns the chosen index."""
    t0 = time.perf_counter()
    if rp.rollout_batched:
        scores, best_dev = rollout()
        best = int(best_dev)  # the ONE host sync per replan
        rp.last_scores = scores[:n_probs]
    else:
        cost_term = rp.theta * sols.cost.cpu().numpy()
        scores = []
        for i in range(n_probs):
            lat_np, fid_np = sequential_one(i)
            scores.append(empirical_objective(lat_np, fid_np, rp.objective) + float(cost_term[i]))
        best = int(np.argmin(scores))
        rp.last_scores = np.asarray(scores)
    rp.rollout_walls.append(time.perf_counter() - t0)
    return best


def _analytic_best(rp, sols) -> int:
    """The fallback without a carry or draws: ``latency_tight + theta * cost``."""
    cost_term = rp.theta * sols.cost.cpu().numpy()
    scores = (sols.latency_tight.cpu().numpy() + cost_term).tolist()
    rp.last_scores = np.asarray(scores)
    return int(np.argmin(scores))


def _record_iters(rp, sols, best: int) -> None:
    if sols.iterations is not None:
        it = sols.iterations.cpu().numpy()
        rp.solve_iters.append(int(it[best] if it.ndim else it))


@dataclasses.dataclass
class AdaptiveReplanner:
    """Re-solve JLCM from estimated state, one batched solve per re-plan.

    :meth:`replan` builds the candidate set, the cross product of
    ``thetas`` (default: the operating theta) and candidate availability
    masks (default: the health-check mask alone), each solved from a cold
    (feasible-uniform) and, when the current plan is supplied, a warm start,
    and solves them all in ONE ``solve_batch`` call.

    Candidate selection is model-predictive when the caller supplies the
    live queue state (``carry``) and randomness (``generator`` or
    ``draws``): each candidate is rolled out from ``carry`` under the
    estimated service family (:meth:`EwmaMomentEstimator.fitted_shifted_exp`)
    and rates, and the lowest empirical objective + theta * cost wins,
    arbitrated by :func:`batched_rollout_scores` (one B1 launch, one host
    sync), or, with ``rollout_batched=False``, by the sequential loop kept as
    the parity baseline (one rollout and host copy per candidate, host
    scoring; it rolls out on the first of the K draws). Without them the
    analytic ``latency_tight + theta * cost`` scores the candidates.

    ``objective`` makes the loop multi-tenant (solves, analytic fallback and
    rollout scores all use it). A ``RepairFlow`` passed to :meth:`replan`
    joins every candidate solve as extra (lam, k, mask) rows with a
    zero-weight class (:meth:`_repair_objective`), so the optimizer sees the
    background load repair puts on each node and steers client dispatch
    around it; rollouts simulate the augmented plan and score client
    requests only; the chosen repair dispatch lands in :attr:`repair_pi`.

    With a ``cache`` model (``storage.cache.CacheModel``) the ``class_rates``
    are miss rates: the replanner inverts them to raw rates through the
    TTLs it last deployed (:attr:`last_ttl`, :attr:`last_raw` the branch
    prior), re-derives TTLs at the new estimate (promotion / demotion) and
    plans the warm tier against miss traffic through a ``CacheSpec``; repair
    rows join at hit 0 and TTL 0. ``cache_up=False`` (a health-checked hot
    tier outage) plans at ``raw * surge_margin`` with zero hits. Rollouts
    replay the planned TTLs, from a cold cache when the carry holds none of
    that shape. The caller deploys :attr:`last_ttl` after each replan.

    The estimator's prior sets the device: solves and rollouts run there,
    and the chosen plan comes back to the host once.
    """

    k: np.ndarray  # (r,) MDS k_i per class/file
    cost: np.ndarray  # (m,) per-node cost V_j
    theta: float
    estimator: EwmaMomentEstimator
    objective: ObjectiveSpec | None = None  # scenario's composed objective
    thetas: tuple[float, ...] | None = None
    max_iters: int = 400
    rollout_requests: int = 600
    # common-random-number rollout draws per candidate (K): each candidate
    # is scored by its K-draw mean
    rollout_seeds: int = 1
    # False: the sequential per-candidate loop, the parity baseline
    rollout_batched: bool = True
    # "auto" or "never": both run on the one device (no sharding branch)
    rollout_devices: str = "auto"
    replans: int = 0
    # reconstruction-read dispatch chosen by the last repair-aware replan
    repair_pi: np.ndarray | None = None
    cache: Any | None = None  # storage.cache.CacheModel, or None
    # TTLs deployed by the last replan (the next inversion's key) and the
    # tracked raw-rate estimate (branch prior), seeded by the caller
    last_ttl: np.ndarray | None = None
    last_raw: np.ndarray | None = None
    # per-replan telemetry: the deployed candidate's iterations, the
    # batched solve's wall, the arbitration's wall (rollout replans only)
    solve_iters: list = dataclasses.field(default_factory=list)
    solve_walls: list = dataclasses.field(default_factory=list)
    rollout_walls: list = dataclasses.field(default_factory=list)
    # per-candidate scores of the last replan (a device tensor when batched)
    last_scores: Any = None
    # rate head-room multiplier for hot-tier-outage replans (cache_up=False)
    surge_margin: float = 1.25

    def _repair_objective(self, device: torch.device) -> ObjectiveSpec:
        """The client objective extended with a zero-weight repair class:
        reconstruction reads add load (through every node's P-K term) but
        never latency credit. Without a tenant mix, clients weigh 1 and
        repair 0."""
        r = int(np.asarray(self.k).shape[0])
        ids = lambda v: torch.full((r,), v, dtype=torch.int64, device=device)
        if self.objective is None:
            return ObjectiveSpec(
                class_id=torch.cat([ids(0), ids(1)]),
                weight=torch.tensor([1.0, 0.0], dtype=torch.float32, device=device),
            )
        spec = self.objective
        n_classes = int(spec.weight.shape[-1])
        zero = torch.zeros((1,), dtype=torch.float32, device=device)
        deadline = tail_weight = None
        if spec.deadline is not None:
            deadline = torch.cat([spec.deadline, torch.full_like(zero, torch.inf)])
            tail_weight = torch.cat([spec.tail_weight, zero])
        return ObjectiveSpec(
            class_id=torch.cat([spec.class_id, ids(n_classes)]),
            weight=torch.cat([spec.weight, zero]),
            deadline=deadline,
            tail_weight=tail_weight,
        )

    def replan(
        self,
        class_rates,
        avail,
        *,
        candidate_masks: list | None = None,
        pi0: np.ndarray | None = None,
        carry: Any | None = None,
        generator: torch.Generator | None = None,
        draws: SimDraws | Callable[[Tensor], SimDraws] | None = None,
        repair: Any | None = None,
        cache_up: bool = True,
    ) -> np.ndarray:
        """New (r, m) dispatch matrix from estimated moments + health mask.

        ``pi0`` (the plan now dispatching) adds warm-started candidates;
        ``carry`` (``storage.simulator.SimCarry``) plus a ``generator`` on
        its device, or explicit rollout ``draws`` (a leading (K,) axis, at
        the planned rates, repair rows included; or a callable that takes
        those rates, (1, rows), and returns them), switch scoring to
        rollouts from the live queue state. ``repair`` (a
        ``storage.repair.RepairFlow``) folds known reconstruction traffic
        into every candidate solve and rollout. With a ``cache`` model,
        ``class_rates`` are miss rates and ``cache_up`` is the hot tier's
        health verdict for the next segment. Ground truth never enters.
        """
        r = int(np.asarray(self.k).shape[0])
        avail = _host(avail).astype(bool)
        masks = [avail] if candidate_masks is None else candidate_masks
        thetas = (self.theta,) if self.thetas is None else tuple(self.thetas)
        mom = self.estimator.moments()
        dev = mom.mu.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        with_repair = repair is not None and repair.active
        k_vec = _host(self.k).astype(np.float32)
        lam_np = _host(class_rates).astype(np.float64)
        cache_spec = ttl_plan = None
        if self.cache is not None:
            # invert miss -> raw through the TTLs those misses were observed
            # under (zeros when the tier was down: identity)
            ttl_prev = np.zeros((r,)) if self.last_ttl is None else np.asarray(
                self.last_ttl, np.float64)
            raw = self.cache.reconstruct_raw_rates(lam_np, ttl_prev, prior=self.last_raw)
            self.last_raw = raw
            if cache_up:
                ttl_plan = self.cache.ttl(raw)  # promotion/demotion
                hit = che_hit_rates(raw, ttl_plan)
                lam_np = raw
            else:
                ttl_plan, hit = np.zeros((r,)), np.zeros((r,))
                # outage plan: full raw load plus surge head-room
                lam_np = raw * float(self.surge_margin)
            self.last_ttl = ttl_plan
        if with_repair:
            lam_np = np.concatenate([lam_np, np.asarray(repair.lam)])
            k_vec = np.concatenate([k_vec, np.asarray(repair.k, np.float32)])
        n_rows = lam_np.shape[0]
        if self.cache is not None:
            # repair rows join with hit 0: reconstruction reads fetch lost
            # chunks, which no hot tier holds
            cache_spec = make_cache_spec(
                np.concatenate([hit, np.zeros((n_rows - r,))]),
                hit_latency=self.cache.hit_latency, hot_cost=self.cache.hot_cost(), device=dev)
        lam = f32(lam_np)
        k_t = f32(k_vec)
        cost_t = f32(self.cost)
        objective = self._repair_objective(dev) if with_repair else self.objective
        probs, starts = [], []
        for t in thetas:
            for mk in masks:
                mask = np.broadcast_to(np.asarray(mk, bool), (r, avail.shape[-1]))
                if with_repair:
                    mask = np.concatenate([mask, np.asarray(repair.mask, bool)], axis=0)
                mask = torch.as_tensor(np.ascontiguousarray(mask), device=dev)
                prob = JLCMProblem(lam=lam, k=k_t, moments=mom, cost=cost_t, theta=float(t),
                                   mask=mask, objective=objective, cache=cache_spec)
                probs.append(prob)
                starts.append(feasible_uniform(mask, prob.k))
                if pi0 is not None:
                    start = _host(pi0)
                    if with_repair:
                        start, _ = augment_plan(start, lam_np[:r], repair)
                    probs.append(prob)
                    starts.append(f32(start))
        t0 = time.perf_counter()
        sols = solve_batch(probs, max_iters=self.max_iters, pi0=torch.stack(starts))
        _sync(dev)
        self.solve_walls.append(time.perf_counter() - t0)
        self.replans += 1

        if carry is not None and (generator is not None or draws is not None):
            d, srv_rates = self.estimator.fitted_shifted_exp()
            d, srv_rates = f32(d), f32(srv_rates)
            avail_t = torch.as_tensor(avail, device=dev)
            ttl_roll = None
            hit_lat = torch.zeros((), dtype=torch.float32, device=dev)
            if self.cache is not None:
                # roll out with the planned TTLs (repair rows TTL 0: never
                # cached) so the scorer sees the load the solver planned for
                ttl_roll = f32(np.concatenate([ttl_plan, np.zeros((n_rows - r,))]))
                hit_lat = f32(self.cache.hit_latency)
                if carry.cache is None or carry.cache.shape != ttl_roll.shape:
                    carry = carry._replace(cache=torch.full(ttl_roll.shape, -torch.inf, device=dev))
            draws = _rollout_draws(generator, draws, lam[None], self.rollout_requests,
                                   avail.shape[-1], self.rollout_seeds)
            cost_dev = self.theta * sols.cost  # device-side cost fold

            def sequential_one(i):
                _, res = run_segment_raw(carry, None, sols.pi[i], lam, d, srv_rates, avail_t,
                                         self.rollout_requests, ttl_roll, hit_lat,
                                         draws=draws.at(0))
                lat_np, fid_np = res.latency.cpu().numpy(), res.file_id.cpu().numpy()
                if with_repair:  # score client traffic only
                    client = fid_np < r
                    lat_np, fid_np = lat_np[client], fid_np[client]
                return lat_np, fid_np

            best = _arbitrate(self, sols, len(probs), lambda: batched_rollout_scores(
                carry, None, sols.pi, lam, d, srv_rates, avail_t, cost_dev, self.objective,
                n_clients=r, n_requests=self.rollout_requests,
                rollout_seeds=self.rollout_seeds, ttl=ttl_roll, hit_latency=hit_lat,
                devices=self.rollout_devices, draws=draws), sequential_one)
        else:
            best = _analytic_best(self, sols)
        _record_iters(self, sols, best)
        pi_best = sols.pi[best].cpu().numpy()
        self.repair_pi = pi_best[r:] if with_repair else None
        return pi_best[:r]


@dataclasses.dataclass
class HierarchicalReplanner:
    """Cluster-granularity closed loop for very large catalogs.

    The catalog is aggregated once into O(100) clusters
    (``core.aggregate``), every replan solves at cluster granularity, and
    the per-file dispatch matrix is the exact gather
    ``cluster_pi[cluster_of_file]``. Two replan tiers:

    * **incremental** (default): ``resolve_incremental`` re-solves only the
      clusters whose estimated rates moved by more than ``rate_threshold``
      (relative), freezing the rest as background load at their new rates;
    * **full**: when the estimated moments drift beyond
      ``moment_threshold`` (relative, any node) from the last *full*
      solve's, or the availability mask changes, the whole cluster problem
      is re-solved from a cold and (every node up) a warm start in one
      ``solve_batch``, the winner chosen by a device argmin over the
      objective.

    Telemetry: ``solve_iters``, ``solve_walls`` and ``resolved_counts``
    (clusters re-solved per replan).
    """

    hierarchy: Hierarchy
    cost: np.ndarray  # (m,) per-node cost V_j
    theta: float
    estimator: EwmaMomentEstimator
    max_iters: int = 300
    eps: float = 1e-4
    rate_threshold: float = 0.2
    moment_threshold: float = 0.05
    plan: FactoredPlan | None = None
    replans: int = 0
    full_solves: int = 0
    solve_iters: list = dataclasses.field(default_factory=list)
    solve_walls: list = dataclasses.field(default_factory=list)
    resolved_counts: list = dataclasses.field(default_factory=list)
    # inputs of the last *full* solve: drift is measured against these, so
    # slow creep accumulates instead of evading the threshold step by step
    _solved_mom: ServiceMoments | None = None
    _solved_avail: np.ndarray | None = None

    def cluster_rates(self, file_rates) -> np.ndarray:
        """Exact (C,) cluster rates from per-file estimates (one bincount)."""
        return np.bincount(
            self.hierarchy.cluster_of_file(),
            weights=_host(file_rates).astype(np.float64),
            minlength=self.hierarchy.n_clusters,
        )

    def _moments_moved(self, mom: ServiceMoments) -> bool:
        if self._solved_mom is None:
            return True
        for new, old in zip(mom, self._solved_mom):
            new = _host(new).astype(np.float64)
            old = _host(old).astype(np.float64)
            tol = self.moment_threshold * np.maximum(np.abs(old), 1e-12)
            if np.any(np.abs(new - old) > tol):
                return True
        return False

    def replan(self, file_rates, avail) -> np.ndarray:
        """New (r, m) dispatch matrix from estimated per-file rates + mask.

        Returns the materialized per-file matrix (one host copy); the
        factored plan stays in :attr:`plan` for the next incremental step.
        """
        avail = _host(avail).astype(bool)
        mom = self.estimator.moments()
        dev = mom.mu.device
        lam_c = self.cluster_rates(file_rates)
        cost = torch.as_tensor(self.cost, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        full = (
            self.plan is None
            or self._moments_moved(mom)
            or self._solved_avail is None
            or not np.array_equal(avail, self._solved_avail)
        )
        if full:
            h = self.hierarchy._replace(lam=lam_c)
            mask = torch.as_tensor(
                np.broadcast_to(avail, (h.n_clusters, avail.shape[-1])).copy(), device=dev)
            prob = build_problem(h, mom, cost, self.theta)._replace(mask=mask)
            # warm AND cold candidates, arbitrated by solved objective: a
            # warm start can stall the relative stop test at its starting
            # point when the moments moved under it. The incumbent is a
            # valid start only while every node it uses is up.
            starts = [feasible_uniform(mask, prob.k)]
            if self.plan is not None and bool(avail.all()):
                starts.append(self.plan.cluster_pi.to(torch.float32))
            sols = solve_batch([prob] * len(starts), max_iters=self.max_iters, eps=self.eps,
                               pi0=torch.stack(starts))
            # device argmin: the winning index crosses, not the objectives
            best = int(torch.argmin(sols.objective))
            self.plan = FactoredPlan(h, sols.pi[best], lam_c.copy())
            it = sols.iterations.cpu().numpy()
            iters = int(it[best] if it.ndim else it)
            self.resolved_counts.append(int(h.n_clusters))
            self.full_solves += 1
            self._solved_mom = mom
            self._solved_avail = avail.copy()
        else:
            self.plan, info = resolve_incremental(
                self.plan, lam_c, mom, cost, self.theta,
                threshold=self.rate_threshold, max_iters=self.max_iters, eps=self.eps,
            )
            iters = int(info.iterations)
            self.resolved_counts.append(int(info.n_resolved))
        pi = materialize(self.plan).cpu().numpy()  # one host copy of the (r, m) plan
        self.solve_walls.append(time.perf_counter() - t0)
        self.solve_iters.append(iters)
        self.replans += 1
        return pi


@dataclasses.dataclass
class GeoAdaptiveReplanner:
    """Geo-aware closed loop: re-place chunks toward the active client site.

    The geo twin of :class:`AdaptiveReplanner`. The moment estimator is
    seeded with the fabric's (C, m) per-(client-site, node) moments and fed
    the geo simulator's per-pair observations; the (C, r) traffic matrix
    (an ``EwmaRateEstimator`` over flattened (site, file) ids, reshaped)
    gives the catalog rates (column sums) and the per-file client mix
    (normalized columns). Each :meth:`replan` builds geo problems
    (``core.geo.geo_problem``) for the same warm/cold x theta x mask grid,
    solved in ONE ``solve_batch``, and arbitrates them by geo rollouts from
    the live queue state (:func:`batched_rollout_scores` with ``geo=True``,
    one B1 launch), under the composed ``objective``; without a carry and
    randomness, by the analytic composed bound.
    """

    k: np.ndarray  # (r,) MDS k_i per file
    cost: np.ndarray  # (m,) per-node cost V_j
    theta: float
    estimator: EwmaMomentEstimator  # prior/updates carry (C, m) arrays
    objective: ObjectiveSpec | None = None
    thetas: tuple[float, ...] | None = None
    max_iters: int = 400
    rollout_requests: int = 600
    # batched-arbitration knobs; see AdaptiveReplanner
    rollout_seeds: int = 1
    rollout_batched: bool = True
    rollout_devices: str = "auto"
    replans: int = 0
    solve_iters: list = dataclasses.field(default_factory=list)
    solve_walls: list = dataclasses.field(default_factory=list)
    rollout_walls: list = dataclasses.field(default_factory=list)
    last_scores: Any = None

    def replan(
        self,
        lam_cs,
        avail,
        *,
        candidate_masks: list | None = None,
        pi0: np.ndarray | None = None,
        carry: Any | None = None,
        generator: torch.Generator | None = None,
        draws: SimDraws | Callable[[Tensor], SimDraws] | None = None,
    ) -> np.ndarray:
        """New (r, m) dispatch matrix from the estimated (C, r) traffic
        matrix plus the health mask; ``carry`` with a ``generator`` or geo
        ``draws`` (leading (K,), ``site_id`` set; or a callable that takes
        the (C, r) rollout rates and returns them) switch to rollouts."""
        lam_cs = _host(lam_cs).astype(np.float64)
        c, r = lam_cs.shape
        avail = _host(avail).astype(bool)
        lam = lam_cs.sum(axis=0)
        # a file observed at (essentially) zero rate has no empirical mix;
        # give it the population-average mix rather than 0/0
        pop = lam_cs.sum(axis=1)
        pop_mix = pop / max(pop.sum(), 1e-12)
        safe = np.maximum(lam, 1e-12)
        mix = np.where((lam > 1e-12)[:, None], (lam_cs / safe).T, pop_mix[None, :])
        site_mom = self.estimator.moments()  # (C, m) tensors
        dev = site_mom.mu.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        masks = [avail] if candidate_masks is None else candidate_masks
        thetas = (self.theta,) if self.thetas is None else tuple(self.thetas)
        lam_t, k_t, cost_t = f32(lam), f32(_host(self.k)), f32(self.cost)
        probs, starts = [], []
        for t in thetas:
            for mk in masks:
                mask = torch.as_tensor(np.broadcast_to(
                    np.asarray(mk, bool), (r, avail.shape[-1])).copy(), device=dev)
                prob = geo_problem(lam_t, k_t, site_mom, mix, cost_t, float(t), mask=mask,
                                   objective=self.objective)
                probs.append(prob)
                starts.append(feasible_uniform(mask, prob.k))
                if pi0 is not None:
                    probs.append(prob)
                    starts.append(f32(_host(pi0)))
        t0 = time.perf_counter()
        sols = solve_batch(probs, max_iters=self.max_iters, pi0=torch.stack(starts))
        _sync(dev)
        self.solve_walls.append(time.perf_counter() - t0)
        self.replans += 1

        if carry is not None and (generator is not None or draws is not None):
            d, srv_rates = (f32(x) for x in self.estimator.fitted_shifted_exp())  # (C, m)
            lam_cs_t = f32(lam_cs)
            avail_t = torch.as_tensor(avail, device=dev)
            draws = _rollout_draws(generator, draws, lam_cs_t, self.rollout_requests,
                                   avail.shape[-1], self.rollout_seeds)

            def sequential_one(i):
                _, res = run_geo_segment_raw(carry, None, sols.pi[i], lam_cs_t, d, srv_rates,
                                             avail_t, self.rollout_requests, draws=draws.at(0))
                return res.latency.cpu().numpy(), res.file_id.cpu().numpy()

            best = _arbitrate(self, sols, len(probs), lambda: batched_rollout_scores(
                carry, None, sols.pi, lam_cs_t, d, srv_rates, avail_t, self.theta * sols.cost,
                self.objective, n_clients=r, n_requests=self.rollout_requests,
                rollout_seeds=self.rollout_seeds, devices=self.rollout_devices, geo=True,
                draws=draws), sequential_one)
        else:
            best = _analytic_best(self, sols)
        _record_iters(self, sols, best)
        return sols.pi[best].cpu().numpy()


# ---------------------------------------------------------------------------
# Hedged serving simulation, on kernel B1.
# ---------------------------------------------------------------------------


class ServingDraws(NamedTuple):
    """The random inputs of :func:`simulate_serving`, each with a leading
    (N,) axis."""

    arrival: Tensor  # arrival times
    class_id: Tensor  # int64 request classes
    u: Tensor  # one U[0, 1) Madow uniform per request
    service: Tensor  # (N, m) service times, one per replica


def simulate_serving(
    generator: torch.Generator | None,
    router: Router,
    class_rates,
    moments_sampler=None,
    n_requests: int = 20000,
    *,
    draws: ServingDraws | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Event-driven FCFS simulation with hedging: first completion wins,
    and hedged copies still occupy their queues (conservative model).

    Runs on the pool's device. The workload, ``moments_sampler(generator,
    (N,))`` (an (N, m) tensor of service times) and one Madow uniform per
    request come from ``generator``, or ``draws`` replaces them. A
    request's replica set is Madow-sampled from its class's pi (projected to
    sum 1 + hedge). Madow sets do not depend on the queues, so every
    replica's queue evolves on its own: ONE B1 launch at (m, N, m), where
    system j keeps only column j of each request's set, gives finish_ij - t_i
    for every replica j in request i's set, and the first-wins latency is
    their min (bitwise ``min(finish) - t``: ``fl(a - t)`` is monotone in a).
    Returns host ``(latency, class_id)`` after the first ``N // 10``
    requests (warm-up).
    """
    m = router.pool.m
    dev = router.pool.cost.device
    if draws is None:
        if generator is None or generator.device != dev:
            raise ValueError(f"pass a torch.Generator on {dev} or explicit draws")
        arrival, class_id = generate_workload(generator, router.pool.rates(class_rates), n_requests)
        service = moments_sampler(generator, (n_requests,))
        u = torch.rand((n_requests,), generator=generator, dtype=torch.float32, device=dev)
        draws = ServingDraws(arrival, class_id, u, service)
    n = draws.arrival.shape[0]
    pi_all = torch.tensor(np.asarray(router.pi), dtype=torch.float32, device=dev)
    if router.hedge > 0:
        kk = float(1 + router.hedge)
        pi_all = project_capped_simplex(
            pi_all * kk, torch.full((pi_all.shape[0],), kk, device=dev))
    masks = madow_sample(draws.u, pi_all[draws.class_id])  # (N, m)
    own = masks[None] & torch.eye(m, dtype=torch.bool, device=dev)[:, None, :]  # (m, N, m)
    lat, _, _ = fcfs_scan(draws.arrival.expand(m, n), own, draws.service.expand(m, n, m))
    latency = torch.where(masks.T, lat, torch.inf).amin(dim=0)  # first wins
    warm = n // 10
    return latency[warm:].cpu().numpy(), draws.class_id[warm:].cpu().numpy()
