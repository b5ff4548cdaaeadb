"""Scenario engine: run a spec under a dispatch policy.

The port of ``repro/scenarios/engine.py``. Three policies, deliberately
spanning the control spectrum:

* ``static``    — Algorithm JLCM once, from the *pre-run ground-truth*
  moments on the healthy cluster; the plan never changes. This is the
  paper's own operating model (plan offline, dispatch forever).
* ``oblivious`` — the Fig.-9 'Oblivious LB' baseline: rate-proportional
  dispatch on full support, never re-planned. No optimization at all.
* ``adaptive``  — closed loop: after every segment the engine feeds the
  simulator's node-side service observations to an EWMA moment estimator
  and the observed per-file traffic to an EWMA rate estimator; at each
  re-plan boundary (``spec.replan_every``) it re-solves JLCM from those
  *estimated* inputs plus the current health mask — warm- and cold-started
  candidates in one batched ``solve_batch`` call, arbitrated by a short
  exact-simulator rollout from the live queue state under the estimated
  service family (`serving.router.AdaptiveReplanner`, one B1 launch).

All solving policies optimize the scenario's *composed* objective when the
spec declares a tenant mix (``ScenarioSpec.objective()``); multi-class
scenarios additionally report per-class empirical mean/p99.

Randomness. Open-loop policies run the whole schedule as one
``simulate_segments`` call (one B1 launch a segment, no host sync between
segments); the closed loop alternates ``simulate_segment`` calls with host
re-planning. Every policy sees identical arrival streams and service
draws: the engine draws each segment's :class:`SimDraws` once per run, at
that segment's policy-independent rates and scales, from a
``torch.Generator`` on the cluster's device seeded with ``seed``, and hands
the same draws to the open-loop schedule and to every closed-loop
segment. Rollouts draw from a second generator seeded with
``seed + 0x5EED``. A caller may pass the draws instead: ``draws`` (a
leading (S,) segment axis) and ``rollout_draws``, a callable
``(segment, rollout rates (C, r)) -> SimDraws`` with a leading (K,) axis,
which is how the tests feed the reference's own draws.

Detection model: the adaptive policy learns moments and rates only from
measurements, but node availability is taken from the scenario's health
trace at each segment boundary — a health checker flags dead nodes within
one segment; we study the value of *re-planning*, not of failure detection.

Repair traffic (``spec.repair_rate > 0``): the reconstruction process is
policy-independent, so the engine injects the repair rows
(`storage.repair.repair_schedule`, derived from the *initial* JLCM plan's
placement) into the simulation under EVERY policy, as extra (pi, lam) rows
activated per segment through the simulator's per-file rate scaling. The
adaptive policy passes each segment's ``RepairFlow`` into
``AdaptiveReplanner.replan`` (repair-aware); ``repair_aware=False`` runs the
ablation. All reported statistics cover client requests only
(``file_id < r``).

Cache-tier scenarios (``spec.cache_capacity_mb > 0``): the simulator runs
the hot tier in the data plane; static and oblivious deploy the Che
deploy-time TTLs and never move; the adaptive loop feeds its rate
estimator MISS traffic only, inverts misses back to raw rates through the
deployed TTLs, re-derives TTLs and re-plans the warm tier cache-aware. A
hot-tier up/down transition *forces* a replan. ``hit_frac`` and
``storage_cost`` join the outcome.

Geo scenarios (``spec.sites`` set) run through :func:`run_geo_scenario`
against the 4-client-site fabric, with a geo-aware closed loop
(``GeoAdaptiveReplanner``) and a deliberately *geo-oblivious* static plan.

The engine is host orchestration: it copies each segment's latencies, file
ids and hits to the host once (the estimators are host numpy), while the
solver's iterations and the rollout arbitration run on the device under
``diag.hot_path``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import (
    Hierarchy,
    JLCMProblem,
    materialize,
    proportional_lb_pi,
    solve,
    solve_hierarchical,
)
from repro_torch.serving import (
    AdaptiveReplanner,
    EwmaMomentEstimator,
    EwmaRateEstimator,
    GeoAdaptiveReplanner,
    HierarchicalReplanner,
)
from repro_torch.storage import (
    Cluster,
    GeoFabric,
    SimDraws,
    build_repair_flow,
    geo_testbed,
    per_class_latency_stats,
    repair_schedule,
    segment_draws,
    simulate_geo_segment,
    simulate_geo_segments,
    simulate_segment,
    simulate_segments,
    tahoe_testbed,
)

from .spec import ScenarioSpec

POLICIES = ("static", "oblivious", "adaptive")
ROLLOUT_SEED_OFFSET = 0x5EED

RolloutDraws = Callable[[int, torch.Tensor], SimDraws]


@dataclasses.dataclass(frozen=True)
class ScenarioOutcome:
    """Per-policy result of one scenario run."""

    scenario: str
    policy: str
    seg_mean: np.ndarray  # (S,) mean latency per segment
    seg_p99: np.ndarray  # (S,) p99 latency per segment
    mean: float  # overall mean latency
    p99: float  # overall p99 latency
    degraded_frac: float  # fraction of requests that hit a down node
    replans: int  # closed-loop re-solves performed
    repair_frac: float = 0.0  # reconstruction reads / all simulated requests
    # per-tenant-class empirical stats (multi-class scenarios only)
    class_mean: np.ndarray | None = None  # (C,)
    class_p99: np.ndarray | None = None  # (C,)
    # per-client-site empirical mean latency (geo scenarios only)
    site_mean: np.ndarray | None = None  # (C_sites,)
    # cache-tier scenarios only: fraction of client requests served by the
    # hot tier, and total storage cost = time-averaged warm-tier plan cost
    # + the provisioned (constant) hot-tier cost
    hit_frac: float = 0.0
    storage_cost: float = float("nan")
    # closed-loop solver telemetry: per-replan iteration count of the
    # deployed candidate and wall seconds of the (batched) solve; empty
    # for open-loop policies
    solve_iters: tuple = ()
    solve_walls: tuple = ()
    # per-replan wall seconds of the rollout arbitration; empty for
    # open-loop policies and for replanners that never roll out
    rollout_walls: tuple = ()
    # hierarchical loop only: clusters re-solved per replan
    resolved_counts: tuple = ()

    @property
    def p99_windowed(self) -> float:
        """Mean of the per-segment p99s — the SLO-dashboard view.

        The pooled :attr:`p99` of a run with a storm window is a quantile
        of the storm alone; averaging the p99 of each reporting window
        weighs every segment's tail, so a policy that drags slow nodes
        into its dispatch sets during *healthy* windows pays for it here.
        """
        return float(np.nanmean(self.seg_p99))

    def row(self) -> dict:
        out = dict(
            scenario=self.scenario,
            policy=self.policy,
            mean=round(self.mean, 3),
            p99=round(self.p99, 3),
            p99_windowed=round(self.p99_windowed, 3),
            degraded_frac=round(self.degraded_frac, 4),
            replans=self.replans,
            repair_frac=round(self.repair_frac, 4),
            seg_means="|".join(f"{v:.2f}" for v in self.seg_mean),
            solve_iters="|".join(str(int(v)) for v in self.solve_iters),
            solve_wall_ms="|".join(f"{1e3 * v:.1f}" for v in self.solve_walls),
            rollout_wall_ms="|".join(f"{1e3 * v:.1f}" for v in self.rollout_walls),
        )
        if self.resolved_counts:
            out["resolved_clusters"] = "|".join(str(int(v)) for v in self.resolved_counts)
        if self.class_mean is not None:
            out["class_means"] = "|".join(f"{v:.2f}" for v in self.class_mean)
            out["class_p99s"] = "|".join(f"{v:.2f}" for v in self.class_p99)
        if self.site_mean is not None:
            out["site_means"] = "|".join(f"{v:.2f}" for v in self.site_mean)
        if np.isfinite(self.storage_cost):
            out["hit_frac"] = round(self.hit_frac, 4)
            out["storage_cost"] = round(self.storage_cost, 3)
        return out


def _segment_stats(
    lat: np.ndarray, include: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Per-window (segment) and pooled latency statistics.

    ``lat`` is (S, N); ``include`` an optional (S, N) boolean mask of the
    requests that count (client rows). Returns ``(seg_mean, seg_p99, mean,
    p99)``. A window with no included requests reports NaN, never a
    0-count statistic.
    """
    if include is None:
        seg_mean = lat.mean(-1)
        seg_p99 = np.percentile(lat, 99, axis=-1)
        pool = lat.reshape(-1)
    else:
        seg_mean = np.asarray(
            [lat[s][include[s]].mean() if include[s].any() else np.nan
             for s in range(lat.shape[0])]
        )
        seg_p99 = np.asarray(
            [np.percentile(lat[s][include[s]], 99) if include[s].any() else np.nan
             for s in range(lat.shape[0])]
        )
        pool = lat[include]
    return seg_mean, seg_p99, float(pool.mean()), float(np.percentile(pool, 99))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _schedule_draws(
    generator: torch.Generator, lam_seq: torch.Tensor, n_requests: int, m: int
) -> SimDraws:
    """Every segment's draws, once per run: segment ``s`` at rates
    ``lam_seq[s]`` ((C, r) rows, one row without client sites), stacked on a
    leading (S,) axis. The same draws serve every policy."""
    per_segment = [segment_draws(generator, lam_seq[s], n_requests, m)
                   for s in range(lam_seq.shape[0])]
    return SimDraws(*(torch.stack(xs) for xs in zip(*per_segment)))


def initial_plan(
    spec: ScenarioSpec,
    cluster: Cluster,
    *,
    max_iters: int = 300,
    cache_aware: bool = True,
):
    """The pre-run JLCM plan from ground-truth healthy-cluster moments.

    Solves the scenario's *composed* objective on the cluster's device.
    Returns ``(pi, moments, solution)``: ``pi`` as host numpy, the full
    solution carrying the Lemma-4 placement that fixes where chunks
    physically live (the repair inventory reads it).

    Cache-tier scenarios solve cache-aware even for the static policy (the
    warm tier sized for the *steady-state miss* traffic, Che hit rates at
    ``spec.lam``); ``cache_aware=False`` is the CACHE-OBLIVIOUS baseline,
    solved for the raw design rates as if the hot tier did not exist.
    """
    dev = cluster.device
    mom = cluster.moments(spec.chunk_mb)
    cache = (
        spec.cache_model().spec(np.asarray(spec.lam), device=dev)
        if spec.has_cache and cache_aware
        else None
    )
    prob = JLCMProblem(
        lam=torch.as_tensor(spec.lam, dtype=torch.float32, device=dev),
        k=torch.as_tensor(spec.k, dtype=torch.float32, device=dev),
        moments=mom,
        cost=cluster.cost,
        theta=spec.theta,
        objective=spec.objective(device=dev),
        cache=cache,
    )
    sol = solve(prob, max_iters=max_iters)
    return _host(sol.pi), mom, sol


def oblivious_plan(spec: ScenarioSpec, cluster: Cluster) -> np.ndarray:
    """Fig.-9 'Oblivious LB': mu-proportional dispatch on full support."""
    mom = cluster.moments(spec.chunk_mb)
    mask = torch.ones((spec.r, cluster.m), dtype=torch.bool, device=cluster.device)
    k = torch.as_tensor(spec.k, dtype=torch.float32, device=cluster.device)
    return _host(proportional_lb_pi(mask, k, mom))


def _rollout_source(seed: int, device: torch.device, rollout_draws: RolloutDraws | None):
    """``(generator, draws_for(segment))``: the rollout generator at
    ``seed + 0x5EED``, or the caller's per-segment draws."""
    if rollout_draws is not None:
        return None, lambda s: functools.partial(rollout_draws, s)
    gen = torch.Generator(device=device).manual_seed(seed + ROLLOUT_SEED_OFFSET)
    return gen, lambda s: None


def run_scenario(
    spec: ScenarioSpec,
    policy: str = "adaptive",
    *,
    seed: int = 0,
    cluster: Cluster | None = None,
    requests_per_segment: int | None = None,
    pi0: np.ndarray | None = None,
    placement0: np.ndarray | None = None,
    repair_aware: bool = True,
    cache_aware: bool = True,
    hierarchy: Hierarchy | None = None,
    draws: SimDraws | None = None,
    rollout_draws: RolloutDraws | None = None,
) -> ScenarioOutcome:
    """Simulate ``spec`` under ``policy`` on ``cluster`` (the testbed on the
    card by default); see the module docstring.

    ``hierarchy`` switches every solving policy onto the hierarchical path
    (a cluster-granularity ``solve_hierarchical`` disaggregated by gather,
    and ``HierarchicalReplanner`` for the adaptive loop); it composes only
    with plain scenarios. ``pi0`` reuses an already-solved initial plan;
    ``placement0`` is the physical chunk layout repair traffic derives from
    (default: the initial plan's placement). ``repair_aware=False`` is the
    repair-oblivious closed-loop ablation; ``cache_aware=False`` the
    CACHE-OBLIVIOUS control plane (policy name suffixed ``-cacheblind``).
    ``draws`` / ``rollout_draws`` replace the generators' draws.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
    if hierarchy is not None and (
        spec.is_geo
        or spec.has_cache
        or spec.repair_rate > 0
        or spec.objective(device="cpu") is not None
    ):
        raise ValueError(
            f"{spec.name}: hierarchical planning composes only with plain "
            "scenarios (no geo fabric, cache tier, repair traffic, or "
            "tenant mix)"
        )
    if spec.is_geo:
        return run_geo_scenario(
            spec,
            policy,
            seed=seed,
            fabric=None if cluster is None else geo_testbed(cluster),
            requests_per_segment=requests_per_segment,
            pi0=pi0,
            draws=draws,
            rollout_draws=rollout_draws,
        )
    cluster = tahoe_testbed() if cluster is None else cluster
    dev = cluster.device
    m = cluster.m
    spec.validate(m)
    n_req = requests_per_segment or spec.requests_per_segment
    n_seg = spec.n_segments
    r = spec.r
    lam32 = np.asarray(spec.lam, np.float32)
    avail_tr = spec.avail_trace(m)
    rate_tr = spec.rate_scales()
    ovh_tr = spec.overhead_scales(m)
    bw_tr = spec.bandwidth_scales(m)

    # Hot/warm cache tier: deploy-time TTLs from the Che characteristic
    # time at the catalog's DESIGN rates; the adaptive control plane
    # re-derives them from estimated raw rates at each replan.
    has_cache = spec.has_cache
    cache_model = spec.cache_model() if has_cache else None
    cache_up = spec.cache_up_trace()
    ttl0 = cache_model.ttl(np.asarray(spec.lam, float)) if has_cache else None

    with_repair = spec.repair_rate > 0
    plan0 = None
    if hierarchy is not None and pi0 is None and policy != "oblivious":
        # cluster-granularity initial plan, disaggregated by gather
        plan0, _ = solve_hierarchical(
            hierarchy, cluster.moments(spec.chunk_mb), cluster.cost, spec.theta,
            max_iters=300,
        )
        pi_init = _host(materialize(plan0))
    elif (pi0 is None and policy != "oblivious") or (with_repair and placement0 is None):
        pi_init, _, sol0 = initial_plan(spec, cluster, cache_aware=cache_aware)
        if placement0 is None:
            placement0 = _host(sol0.placement).astype(bool)
    else:
        pi_init = None

    if policy == "oblivious":
        pi = oblivious_plan(spec, cluster)
    elif pi0 is not None:
        pi = np.array(pi0)
    else:
        pi = pi_init

    # The physical reconstruction process: per-segment repair rows from the
    # placement, activated through per-file rate scaling (repair rows at
    # lam 1.0; the reads/sec ride in the scale).
    if with_repair:
        lam_rep_seq, pi_rep_seq = repair_schedule(
            placement0, np.asarray(spec.k), avail_tr, spec.repair_rate
        )
        lam_sim = np.concatenate([lam32, np.ones((r,), np.float32)])
    else:
        lam_rep_seq = pi_rep_seq = None
        lam_sim = lam32

    def seg_scale(s: int) -> np.ndarray | float:
        if not with_repair:
            return float(rate_tr[s])
        return np.concatenate([np.full((r,), float(rate_tr[s])), lam_rep_seq[s]])

    def seg_pi(client_pi: np.ndarray, s: int, repair_pi=None) -> np.ndarray:
        if not with_repair:
            return np.asarray(client_pi)
        rep = pi_rep_seq[s] if repair_pi is None else repair_pi
        return np.concatenate([np.asarray(client_pi), rep], axis=0)

    scale_seq = np.stack([seg_scale(s) for s in range(n_seg)]) if with_repair else rate_tr
    if draws is None:
        lam_t = torch.as_tensor(lam_sim, device=dev)
        scales = torch.as_tensor(scale_seq, dtype=torch.float32, device=dev)
        lam_seq = torch.stack([(lam_t * scales[s])[None] for s in range(n_seg)])
        draws = _schedule_draws(torch.Generator(device=dev).manual_seed(seed), lam_seq, n_req, m)

    replans = 0
    solve_iters = solve_walls = rollout_walls = resolved_counts = ()
    hit = None
    pi_deployed = None  # (S, r, m) what actually dispatched, for cost
    if policy in ("static", "oblivious"):
        pi_seq = np.stack([seg_pi(pi, s) for s in range(n_seg)]) if with_repair else pi
        ttl_seq = np.where(cache_up[:, None], ttl0[None, :], 0.0) if has_cache else None
        res = simulate_segments(
            None,
            pi_seq,
            lam_sim,
            cluster,
            spec.chunk_mb,
            n_req,
            avail_seq=avail_tr,
            rate_scale_seq=scale_seq,
            overhead_scale_seq=ovh_tr,
            bandwidth_scale_seq=bw_tr,
            cache_ttl_seq=ttl_seq,
            cache_hit_latency=spec.cache_hit_latency,
            draws=draws,
        )
        lat = _host(res.latency)  # (S, N)
        degraded = _host(res.degraded)
        fid = _host(res.file_id)
        if has_cache:
            hit = _host(res.hit)
        pi_deployed = np.broadcast_to(np.asarray(pi)[None], (n_seg,) + np.asarray(pi).shape)
    else:
        mom0 = cluster.moments(spec.chunk_mb)
        moment_est = EwmaMomentEstimator(prior=mom0)
        # with a cache tier the estimator tracks MISS rates (prior =
        # design-rate misses); the cache-blind loop mistakes misses for the
        # whole workload (prior = raw design rates, no inversion)
        rate_est = EwmaRateEstimator(
            prior=cache_model.thin(np.asarray(spec.lam, float))
            if has_cache and cache_aware
            else np.asarray(spec.lam)
        )
        if hierarchy is not None:
            replanner = HierarchicalReplanner(
                hierarchy=hierarchy,
                cost=_host(cluster.cost),
                theta=spec.theta,
                estimator=moment_est,
            )
            if plan0 is not None:
                # seed the incumbent factored plan so the first boundary
                # can go incremental instead of re-solving from scratch
                replanner.plan = plan0
                replanner._solved_mom = mom0
                replanner._solved_avail = avail_tr[0].copy()
        else:
            replanner = AdaptiveReplanner(
                k=np.asarray(spec.k),
                cost=_host(cluster.cost),
                theta=spec.theta,
                estimator=moment_est,
                objective=spec.objective(device=dev),
                cache=cache_model if cache_aware else None,
            )
        if has_cache and cache_aware:
            # seed the inversion state with what is actually deployed
            replanner.last_ttl = ttl0.copy()
            replanner.last_raw = np.asarray(spec.lam, float)
        ttl_cur = ttl0  # TTLs currently deployed to the data plane
        rollout_gen, rollout_for = _rollout_source(seed, dev, rollout_draws)
        carry = None
        repair_pi = None  # replanner-optimized reconstruction dispatch
        repair_avail = None  # the health mask repair_pi was solved under
        lats, degs, fids, hits, pis = [], [], [], [], []
        for s in range(n_seg):
            # the hot tier's up/down state is a binary health signal known
            # at segment boundaries: a transition forces a replan so the
            # warm tier is re-planned BEFORE the miss storm lands
            cache_flip = has_cache and cache_aware and s > 0 and bool(
                cache_up[s] != cache_up[s - 1]
            )
            cadence = s % spec.replan_every == 0
            if has_cache and cache_aware and not cache_up[s]:
                # hold the flip-time storm plan for the whole outage window:
                # it was solved from the CONVERGED pre-outage raw estimate
                cadence = False
            if s > 0 and (cadence or cache_flip):
                if hierarchy is not None:
                    pi = replanner.replan(rate_est.rates, avail_tr[s])
                else:
                    flow = (
                        build_repair_flow(
                            placement0, np.asarray(spec.k), avail_tr[s], spec.repair_rate
                        )
                        if with_repair and repair_aware
                        else None
                    )
                    pi = replanner.replan(
                        rate_est.rates,
                        avail_tr[s],
                        pi0=pi,
                        carry=carry,
                        generator=rollout_gen,
                        draws=rollout_for(s),
                        repair=flow,
                        cache_up=bool(cache_up[s]),
                    )
                    repair_pi = replanner.repair_pi
                    repair_avail = avail_tr[s].copy()
                    if has_cache and cache_aware:
                        ttl_cur = replanner.last_ttl
            # the optimized reconstruction dispatch is only valid for the
            # health mask it was solved under; if availability moved since,
            # fall back to the schedule's k-of-surviving rows
            rep_s = (
                repair_pi
                if repair_pi is not None and np.array_equal(avail_tr[s], repair_avail)
                else None
            )
            t_start = 0.0 if carry is None else float(carry.t0)
            res_s, carry = simulate_segment(
                None,
                seg_pi(pi, s, rep_s),
                lam_sim,
                cluster,
                spec.chunk_mb,
                n_req,
                avail=avail_tr[s],
                rate_scale=seg_scale(s),
                overhead_scale=ovh_tr[s],
                bandwidth_scale=bw_tr[s],
                carry=carry,
                cache_ttl=np.where(cache_up[s], ttl_cur, 0.0) if has_cache else None,
                cache_hit_latency=spec.cache_hit_latency,
                draws=draws.at(s),
            )
            moment_est.update(res_s.obs)
            fid_s = _host(res_s.file_id)
            client_s = fid_s < r
            dur = float(res_s.t_end) - t_start
            if has_cache:
                hit_s = _host(res_s.hit)
                rate_est.update_misses(fid_s[client_s], hit_s[client_s], dur)
                hits.append(hit_s)
            else:
                rate_est.update(fid_s[client_s], dur)
            lats.append(_host(res_s.latency))
            degs.append(_host(res_s.degraded))
            fids.append(fid_s)
            pis.append(np.asarray(pi))
        lat = np.stack(lats)
        degraded = np.stack(degs)
        fid = np.stack(fids)
        if has_cache:
            hit = np.stack(hits)
        pi_deployed = np.stack(pis)
        replans = replanner.replans
        solve_iters = tuple(replanner.solve_iters)
        solve_walls = tuple(replanner.solve_walls)
        rollout_walls = tuple(getattr(replanner, "rollout_walls", ()))
        resolved_counts = tuple(getattr(replanner, "resolved_counts", ()))

    # All reported statistics cover CLIENT requests only; repair rows
    # (file_id >= r) are background load.
    client = fid < r
    seg_mean, seg_p99, pooled_mean, pooled_p99 = _segment_stats(lat, client)

    class_mean = class_p99 = None
    if spec.class_id is not None:
        stats = per_class_latency_stats(
            lat[client], fid[client], np.asarray(spec.class_id), spec.n_classes
        )
        class_mean, class_p99 = stats.mean, stats.p99

    hit_frac = 0.0
    storage_cost = float("nan")
    if has_cache:
        hit_frac = float(hit[client].mean())
        # warm-tier cost of what actually dispatched (support x V_j),
        # time-averaged over segments, plus the provisioned hot tier
        cost_v = _host(cluster.cost).astype(float)
        warm = float(np.mean(
            [((pi_deployed[s] > 1e-3) * cost_v).sum() for s in range(n_seg)]
        ))
        storage_cost = warm + cache_model.hot_cost()

    return ScenarioOutcome(
        scenario=spec.name,
        policy=policy if cache_aware or not has_cache else f"{policy}-cacheblind",
        seg_mean=seg_mean,
        seg_p99=seg_p99,
        mean=pooled_mean,
        p99=pooled_p99,
        degraded_frac=float(degraded[client].mean()),
        replans=replans,
        repair_frac=float(1.0 - client.mean()),
        class_mean=class_mean,
        class_p99=class_p99,
        hit_frac=hit_frac,
        storage_cost=storage_cost,
        solve_iters=solve_iters,
        solve_walls=solve_walls,
        rollout_walls=rollout_walls,
        resolved_counts=resolved_counts,
    )


def run_geo_scenario(
    spec: ScenarioSpec,
    policy: str = "adaptive",
    *,
    seed: int = 0,
    fabric: GeoFabric | None = None,
    requests_per_segment: int | None = None,
    pi0: np.ndarray | None = None,
    draws: SimDraws | None = None,
    rollout_draws: RolloutDraws | None = None,
) -> ScenarioOutcome:
    """Run a geo scenario (``spec.sites`` set) under ``policy``.

    * ``static`` — the *geo-oblivious* plan: Algorithm JLCM from the base
      cluster's single-implicit-client moments, never re-planned.
    * ``oblivious`` — rate-proportional dispatch.
    * ``adaptive`` — the geo closed loop: per-(site, node) moment EWMA +
      per-(site, file) rate EWMA feeding ``GeoAdaptiveReplanner``.

    All policies simulate against the same fabric ground truth (per-pair
    service, the spec's mix schedule, its egress trace) on the same draws;
    statistics additionally report per-client-site means. ``fabric``
    defaults to ``geo_testbed()`` on the card.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
    fabric = geo_testbed() if fabric is None else fabric
    dev = fabric.cluster.device
    m, r, c = fabric.m, spec.r, fabric.n_sites
    spec.validate(m)
    spec.validate_geo_fabric(fabric)
    n_req = requests_per_segment or spec.requests_per_segment
    n_seg = spec.n_segments
    lam_cs_seq = spec.lam_cs_schedule()  # (S, C, r)
    avail_tr = spec.avail_trace(m)
    ovh_tr, bw_tr = spec.egress_scales(fabric)  # (S, C, m) each
    if draws is None:
        lam_seq = torch.as_tensor(lam_cs_seq, dtype=torch.float32, device=dev)
        draws = _schedule_draws(torch.Generator(device=dev).manual_seed(seed), lam_seq, n_req, m)

    if policy == "oblivious":
        pi = oblivious_plan(spec, fabric.cluster)
    elif pi0 is not None:
        pi = np.array(pi0)
    else:
        pi, _, _ = initial_plan(spec, fabric.cluster)  # geo-oblivious

    replans = 0
    solve_iters = solve_walls = rollout_walls = ()
    if policy in ("static", "oblivious"):
        res = simulate_geo_segments(
            None,
            pi,
            lam_cs_seq,
            fabric,
            spec.chunk_mb,
            n_req,
            avail_seq=avail_tr,
            overhead_scale_seq=ovh_tr,
            bandwidth_scale_seq=bw_tr,
            draws=draws,
        )
        lat = _host(res.latency)  # (S, N)
        degraded = _host(res.degraded)
        site = _host(res.site_id)
    else:
        moment_est = EwmaMomentEstimator(prior=fabric.moments(spec.chunk_mb))
        rate_est = EwmaRateEstimator(prior=lam_cs_seq[0].reshape(-1))
        replanner = GeoAdaptiveReplanner(
            k=np.asarray(spec.k),
            cost=_host(fabric.cluster.cost),
            theta=spec.theta,
            estimator=moment_est,
            objective=spec.objective(device=dev),
        )
        rollout_gen, rollout_for = _rollout_source(seed, dev, rollout_draws)
        carry = None
        lats, degs, sites = [], [], []
        for s in range(n_seg):
            if s > 0 and s % spec.replan_every == 0:
                pi = replanner.replan(
                    rate_est.rates.reshape(c, r),
                    avail_tr[s],
                    pi0=pi,
                    carry=carry,
                    generator=rollout_gen,
                    draws=rollout_for(s),
                )
            t_start = 0.0 if carry is None else float(carry.t0)
            res_s, carry = simulate_geo_segment(
                None,
                pi,
                lam_cs_seq[s],
                fabric,
                spec.chunk_mb,
                n_req,
                avail=avail_tr[s],
                overhead_scale=ovh_tr[s],
                bandwidth_scale=bw_tr[s],
                carry=carry,
                draws=draws.at(s),
            )
            moment_est.update(res_s.obs)
            fid_s = _host(res_s.file_id)
            site_s = _host(res_s.site_id)
            rate_est.update(site_s * r + fid_s, float(res_s.t_end) - t_start)
            lats.append(_host(res_s.latency))
            degs.append(_host(res_s.degraded))
            sites.append(site_s)
        lat = np.stack(lats)
        degraded = np.stack(degs)
        site = np.stack(sites)
        replans = replanner.replans
        solve_iters = tuple(replanner.solve_iters)
        solve_walls = tuple(replanner.solve_walls)
        rollout_walls = tuple(replanner.rollout_walls)

    site_mean = np.asarray(
        [lat[site == ci].mean() if (site == ci).any() else np.nan for ci in range(c)]
    )
    seg_mean, seg_p99, pooled_mean, pooled_p99 = _segment_stats(lat)
    return ScenarioOutcome(
        scenario=spec.name,
        policy=policy,
        seg_mean=seg_mean,
        seg_p99=seg_p99,
        mean=pooled_mean,
        p99=pooled_p99,
        degraded_frac=float(degraded.mean()),
        replans=replans,
        site_mean=site_mean,
        solve_iters=solve_iters,
        solve_walls=solve_walls,
        rollout_walls=rollout_walls,
    )


def run_all_policies(
    spec: ScenarioSpec,
    *,
    seed: int = 0,
    cluster: Cluster | None = None,
    requests_per_segment: int | None = None,
    repair_aware: bool = True,
    include_cacheblind: bool = False,
    hierarchy: Hierarchy | None = None,
    draws: SimDraws | None = None,
    rollout_draws: RolloutDraws | None = None,
) -> list[ScenarioOutcome]:
    """All three policies on identical arrival/service draws, sharing one
    initial JLCM solve between static and adaptive — and one physical
    placement (hence one repair schedule) across all three.

    ``include_cacheblind=True`` (cache scenarios only) appends the
    cache-oblivious static baseline (policy ``static-cacheblind``).
    ``hierarchy`` routes every policy through the hierarchical path; each
    policy re-solves the cheap cluster-granularity initial plan."""
    common = dict(seed=seed, requests_per_segment=requests_per_segment, draws=draws,
                  rollout_draws=rollout_draws)
    if hierarchy is not None:
        return [run_scenario(spec, policy, cluster=cluster, hierarchy=hierarchy, **common)
                for policy in POLICIES]
    if spec.is_geo:
        fabric = geo_testbed(cluster) if cluster is not None else geo_testbed()
        pi0, _, _ = initial_plan(spec, fabric.cluster)
        return [
            run_geo_scenario(spec, policy, fabric=fabric,
                             pi0=None if policy == "oblivious" else pi0, **common)
            for policy in POLICIES
        ]
    cluster = tahoe_testbed() if cluster is None else cluster
    pi0, _, sol0 = initial_plan(spec, cluster)
    placement0 = _host(sol0.placement).astype(bool)
    out = [
        run_scenario(spec, policy, cluster=cluster, pi0=None if policy == "oblivious" else pi0,
                     placement0=placement0, repair_aware=repair_aware, **common)
        for policy in POLICIES
    ]
    if include_cacheblind and spec.has_cache:
        out.append(run_scenario(spec, "static", cluster=cluster, placement0=placement0,
                                cache_aware=False, **common))
    return out
