"""The built-in scenario registry.

The port of ``repro/scenarios/library.py``: the same thirteen scenarios,
field by field, over the paper's 12-node, 3-site testbed model
(`storage.cluster.tahoe_testbed`), each probing one claim of the paper or
a phenomenon from the follow-up literature (arXiv:1703.08337 degraded
reads / stragglers, arXiv:2005.10855 load shifts, arXiv:1807.02253
network-path heterogeneity, f4's hot/warm tiering).

Node numbering (see ``tahoe_testbed``): 0-3 NJ (fast, client-local),
4-7 TX (slow), 8-11 CA (medium). The two geo scenarios
(`geo-client-shift`, `cross-site-outage`) run the 4-client-site fabric
(``geo_testbed``: NJ reference, TX, CA, EU remote) instead of the
implicit single NJ client. The three cache scenarios (`cache-warmup`,
`cache-outage`, `flash-crowd-cached`) put a replicated hot tier
(`storage/cache.py`) in front of the warm tier at DOUBLE the default
catalog rates — the load level only works *because* the cache thins it,
which is exactly the f4 operating regime.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cluster_catalog, effective_chunk_mb, synthetic_catalog

from .spec import ScenarioSpec, diurnal_trace, register

# Cache-tier catalog: double the default rates. The warm tier alone would
# run hot at these rates; with the hot tier absorbing 30-60% per file the
# *miss* load is comfortable — so planning for raw vs miss traffic
# produces materially different plans (the whole point of the tier).
CACHE_LAM = (0.09, 0.07, 0.04, 0.03)

STEADY_STATE = register(
    ScenarioSpec(
        name="steady-state",
        description="Stationary Poisson workload on a healthy cluster; the "
        "control scenario (and the smallest — CI smoke runs it).",
        probes="Lemma 2 bound validity and closed-loop no-regret: with "
        "nothing changing, re-planning from estimated moments must not "
        "degrade the static-optimal plan.",
        expected="static ≈ adaptive; oblivious pays the Fig.-9 gap. The "
        "EWMA moment estimates converge to the cluster's true moments.",
        n_segments=4,
        requests_per_segment=1200,
    )
)

NODE_FAILURE = register(
    ScenarioSpec(
        name="node-failure",
        description="The fastest node (nj0) fails at segment 2 and recovers "
        "at segment 6 of 8.",
        probes="The paper plans against a fixed healthy cluster; degraded "
        "reads under failure are the central regime of arXiv:1703.08337. "
        "Exercises the failover path that Router.precompute_failover "
        "tabulates.",
        expected="static keeps sending Madow picks to the dead node and "
        "falls back to random spares (degraded reads); adaptive re-plans "
        "pi around the failure and wins on mean and p99 during the outage, "
        "then re-converges after recovery.",
        failures=((0, 2, 5),),
    )
)

NODE_FAILURE_REPAIR = register(
    ScenarioSpec(
        name="node-failure-repair",
        description="Same outage as node-failure (nj0 down segments 2-5), "
        "but a repair process reconstructs the lost chunks at a fixed "
        "pacer rate while the node is down — reconstruction k-of-n reads "
        "land on the surviving placement nodes as background load.",
        probes="Repair-induced background load, the regime arXiv:1703.08337 "
        "identifies as decisive for tail latency and arXiv:2005.10855 "
        "models as a latency-cost operating-point shift. The paper's "
        "optimizer never sees reconstruction traffic; here it must. "
        "Exercises storage/repair.py end to end and the repair-aware "
        "AdaptiveReplanner (repair rows folded into candidate solves "
        "and rollouts).",
        expected="reconstruction traffic measurably raises client latency "
        "under the repair-oblivious static plan (worse than plain "
        "node-failure static); the repair-aware adaptive policy re-plans "
        "client dispatch around the repair-loaded nodes and recovers a "
        "lower mean and p99.",
        failures=((0, 2, 5),),
        repair_rate=0.05,
    )
)

SITE_OUTAGE = register(
    ScenarioSpec(
        name="site-outage",
        description="Staggered brownout of the NJ site: nj0 and nj1 down "
        "segments 2-4, nj2 down segments 3-5.",
        probes="Correlated failures — the multi-node masked re-plan that "
        "one batched solve_batch call covers; stresses the capped-simplex "
        "feasibility margin when the fast site shrinks.",
        expected="larger adaptive win than single-node failure: the static "
        "plan's NJ-heavy dispatch degrades to random spares on the slow "
        "sites, while adaptive shifts load to CA.",
        failures=((0, 2, 4), (1, 2, 4), (2, 3, 5)),
    )
)

FLASH_CROWD = register(
    ScenarioSpec(
        name="flash-crowd",
        description="Arrival rates jump to 2.2x for segments 3-4, then "
        "drop back.",
        probes="The lambda-sensitivity of the optimal plan (paper Fig. 12: "
        "latency vs arrival rate is convex and steepens with load); "
        "load-shift adaptation from arXiv:2005.10855.",
        expected="during the crowd, the static plan overloads the few fast "
        "nodes it concentrated on (P-K delay blows up in 1/(1-rho)); "
        "adaptive observes the rate jump via the EWMA rate estimator and "
        "re-spreads dispatch, cutting the spike's mean and p99.",
        rate_trace=(1.0, 1.0, 1.0, 2.2, 2.2, 1.0, 1.0, 1.0),
    )
)

DIURNAL = register(
    ScenarioSpec(
        name="diurnal",
        description="Sinusoidal arrival-rate ramp (0.6x to 1.6x) over one "
        "compressed 'day' of 8 segments.",
        probes="Slow non-stationarity: can a fixed cadence of cheap batched "
        "re-solves track a continuously drifting lambda?",
        expected="adaptive tracks the ramp with ~1-segment lag and matches "
        "or beats static at the peak; at the trough all policies agree "
        "(low load hides plan quality).",
        rate_trace=diurnal_trace(8),
    )
)

PREMIUM_BURST = register(
    ScenarioSpec(
        name="premium-burst",
        description="Two-tenant mix — files 0-1 are a premium class "
        "(weighted 6x, tail-bounded), files 2-3 background — hit by a "
        "2x arrival burst in segments 3-4.",
        probes="The pluggable objective layer end to end: differentiated "
        "per-class weighted latency (arXiv:1602.05551) composed with a "
        "premium tail-probability bound (arXiv:1703.08337 regime), "
        "optimized by the solver AND enforced by the replanner's "
        "objective-aware rollout scoring during the burst.",
        expected="the weighted plan keeps the premium class's mean and p99 "
        "below the background class's throughout; during the burst the "
        "adaptive policy re-spreads background load while the premium "
        "class is protected (its latency rises far less than background's "
        "and than under the oblivious plan).",
        rate_trace=(1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 1.0),
        class_id=(0, 0, 1, 1),
        class_weight=(6.0, 1.0),
        class_deadline=(28.0, None),
        class_tail_weight=(0.5, 0.0),
    )
)

GEO_CLIENT_SHIFT = register(
    ScenarioSpec(
        name="geo-client-shift",
        description="Follow-the-sun: the client population migrates "
        "NJ -> TX -> CA over one compressed day (geo fabric, "
        "storage/cluster.py::geo_testbed), with a small always-on EU "
        "remote population. No node ever fails and no rate changes — "
        "only WHERE the requests come from.",
        probes="The paper's three-DC geometry (§V.A, Fig. 5) reduced to "
        "its essence: per-(client-site, node) service heterogeneity "
        "(arXiv:1807.02253's network-scale regime, arXiv:2005.10855's "
        "load-shift modeling) changes the optimal placement, not just "
        "the constants. Exercises core/geo.py end to end: pair moments "
        "through the solver, estimated client mix through "
        "GeoAdaptiveReplanner.",
        expected="the static geo-oblivious plan (solved from the "
        "single-implicit-NJ-client view) keeps dispatching to "
        "NJ-favoring placements after the population has moved west and "
        "pays WAN service times; the geo closed loop watches the "
        "per-site traffic mix drift and re-places chunks toward the "
        "active client site, beating static on mean latency.",
        lam=(0.036, 0.028, 0.016, 0.012),
        sites=("NJ", "TX", "CA", "EU"),
        mix_trace=(
            (0.80, 0.10, 0.05, 0.05),
            (0.80, 0.10, 0.05, 0.05),
            (0.50, 0.35, 0.10, 0.05),
            (0.15, 0.65, 0.15, 0.05),
            (0.05, 0.40, 0.50, 0.05),
            (0.05, 0.10, 0.80, 0.05),
            (0.05, 0.10, 0.80, 0.05),
            (0.40, 0.10, 0.45, 0.05),
        ),
    )
)

CROSS_SITE_OUTAGE = register(
    ScenarioSpec(
        name="cross-site-outage",
        description="The NJ data center's EGRESS degrades for segments "
        "2-5 — cross-site clients see 1.5x the service-overhead floor "
        "(the RTT-dominated deterministic part of every read) and 70% "
        "of the bandwidth to NJ nodes — while every node stays up and "
        "NJ-local clients are unaffected (the WAN link, not the DC, is "
        "the fault domain). Client population is spread across all four "
        "sites.",
        probes="Correlated *network* degradation, invisible to any "
        "per-node health check or per-node moment estimate: only the "
        "per-(client-site, node) observation matrix shows the row "
        "pattern (remote rows to NJ slow, local row healthy). The "
        "regime arXiv:1807.02253 models as general service-time "
        "inflation on network paths.",
        expected="static keeps its NJ-heavy placement (NJ nodes are "
        "still the fastest from its implicit-NJ vantage) and remote "
        "clients pay the degraded egress; the geo closed loop's pair "
        "estimates surface the egress pattern and re-planning shifts "
        "dispatch toward TX/CA for the window, then back after the "
        "link heals.",
        lam=(0.036, 0.028, 0.016, 0.012),
        sites=("NJ", "TX", "CA", "EU"),
        mix_trace=((0.30, 0.30, 0.30, 0.10),) * 8,
        egress_degrade=(("NJ", 2, 5, 1.5, 0.7),),
    )
)

CACHE_WARMUP = register(
    ScenarioSpec(
        name="cache-warmup",
        description="A hot tier (100 MB over a 250 MB catalog) starts COLD "
        "at 2x the default catalog rates; nothing else changes. The first "
        "segments see near-full raw load at the warm tier while the cache "
        "fills; steady state thins 30-60% per file.",
        probes="The f4 hot/warm split as a planning problem: Eq. (9)'s "
        "arrival rates are really lam_i(1-h_i), and h_i is a *transient*. "
        "A deploy-time plan sized for steady-state misses (the correct "
        "stationary answer) meets the cold-start miss storm; the Che/TTL "
        "model (storage/cache.py) says where h_i settles, the closed loop "
        "must survive the path there.",
        expected="static (cache-aware but frozen at steady-state miss "
        "rates) backlogs during segments 0-1 and drags the tail for the "
        "whole run; adaptive observes the real miss rates, plans wide "
        "while the cache is cold, and tightens as hits arrive — better "
        "mean AND p99 at equal-or-lower total storage cost (asserted by "
        "tests/test_cache.py and benchmarks/cache_tier.py).",
        lam=CACHE_LAM,
        theta=4.0,
        cache_capacity_mb=100.0,
        cache_hit_latency=0.5,
        cache_hot_price=0.02,
    )
)

CACHE_OUTAGE = register(
    ScenarioSpec(
        name="cache-outage",
        description="Steady cached operation at 2x rates, then the hot "
        "tier goes DOWN for segments 3-5 of 9 (cache flush included: it "
        "re-warms from cold after recovery). Every request hits the warm "
        "tier at full raw load during the window.",
        probes="The regime that decides whether a cache tier is load-"
        "bearing infrastructure or an optimization: the warm tier behind "
        "a healthy cache sees HALF the traffic, so a plan sized for miss "
        "load is ~2x under-provisioned the moment the tier vanishes. "
        "Hot-tier up/down is a binary health signal (same detection "
        "model as node failures), so the closed loop can re-plan AT the "
        "boundary, before the miss storm lands.",
        expected="static boils during the outage (its miss-sized plan "
        "eats raw load; queues back up and the backlog pollutes segments "
        "after recovery too); adaptive re-plans for reconstructed raw "
        "rates at the outage edge, spreads onto more nodes for the "
        "window, then re-tightens once the tier re-warms — better mean "
        "AND p99 at equal-or-lower storage cost (asserted).",
        n_segments=9,
        lam=CACHE_LAM,
        theta=4.0,
        cache_capacity_mb=100.0,
        cache_hit_latency=0.5,
        cache_hot_price=0.02,
        cache_outage=((3, 5),),
    )
)

FLASH_CROWD_CACHED = register(
    ScenarioSpec(
        name="flash-crowd-cached",
        description="The flash-crowd rate spike (2.2x for segments 3-4) "
        "replayed WITH the hot tier in front: at a fixed TTL, a hotter "
        "file hits MORE often (h_i = 1 - exp(-lam_i * T)), so the cache "
        "absorbs a disproportionate share of the surge.",
        probes="The cache as a shock absorber — the miss rate grows "
        "sublinearly in the raw rate, a property the Che model predicts "
        "quantitatively and the plain flash-crowd scenario lacks. Also "
        "the promotion path: the adaptive control plane re-derives TTLs "
        "from estimated raw rates mid-surge.",
        expected="the surge's effective (miss) amplitude at the warm tier "
        "is well below 2.2x — hit_frac RISES during the spike; all "
        "policies fare better than in the uncached flash-crowd, and "
        "adaptive still wins the spike segments by re-spreading the "
        "residual miss surge.",
        lam=CACHE_LAM,
        theta=4.0,
        rate_trace=(1.0, 1.0, 1.0, 2.2, 2.2, 1.0, 1.0, 1.0),
        cache_capacity_mb=100.0,
        cache_hit_latency=0.5,
        cache_hot_price=0.02,
    )
)

def hotspot_drift_hierarchical(
    r: int = 100_000,
    *,
    seed: int = 0,
    n_rate_clusters: int = 8,
    requests_per_segment: int = 2000,
    total_rate: float = 0.04,
):
    """The hotspot-drift scenario at catalog scale: ``(spec, hierarchy)``.

    Same NJ-degradation schedule as the registered ``hotspot-drift``, but
    over a synthetic r-file catalog (``core.aggregate.synthetic_catalog``,
    default 10^5 files at the SAME total traffic as the 4-file default) so
    the closed loop must run the hierarchical path — dense per-file
    re-solves at this r would dwarf the segment budget. Pass both returns
    to the engine: ``run_scenario(spec, hierarchy=hierarchy)``.

    Deliberately NOT registered: the registry is enumerated by CI smoke
    tests and the scenario suite, and a 10^5-file spec is a benchmark
    workload, not a smoke one (``chip_smoke.py`` phase 10c runs it, as the
    reference's ``benchmarks/jlcm_scaling.py`` does).
    """
    # total_rate is calibrated DOWN from the benchmark catalog's 0.125:
    # the synthetic catalog's traffic-weighted chunk is ~35 MB against the
    # default scenario's 12.5, so matching the default testbed's byte load
    # (lam * k * chunk) needs roughly a third of the request rate
    cat = synthetic_catalog(r, seed=seed, total_rate=total_rate)
    hierarchy = cluster_catalog(cat, n_rate_clusters=n_rate_clusters)
    spec = dataclasses.replace(
        HOTSPOT_DRIFT,
        name=f"hotspot-drift-hier-{r}",
        description=f"hotspot-drift over a {r}-file synthetic catalog, "
        "planned through the hierarchical (cluster-granularity) path.",
        probes="Million-file planning: volume/cluster aggregation with "
        "exact gather disaggregation and warm-started incremental "
        "re-solves (HierarchicalReplanner) under genuine moment drift.",
        expected="same qualitative ranking as hotspot-drift (adaptive "
        "recovers most of the drift gap) with cluster-granularity solver "
        "work: full re-solves only when the moment EWMA drifts, "
        "incremental (few-cluster) solves otherwise.",
        lam=tuple(cat.lam),
        k=tuple(float(v) for v in cat.k),
        chunk_mb=float(effective_chunk_mb(hierarchy)),
        requests_per_segment=requests_per_segment,
        # the latency term is an average over files while the cost term
        # SUMS over them, so the price of a byte must fall as 1/r or the
        # cost term swamps latency and the solver collapses every row to
        # minimal support; this keeps the latency/cost balance of the
        # 4-file original at any catalog size
        theta=HOTSPOT_DRIFT.theta * len(HOTSPOT_DRIFT.lam) / r,
    )
    return spec, hierarchy


HOTSPOT_DRIFT = register(
    ScenarioSpec(
        name="hotspot-drift",
        description="The NJ site degrades progressively (bandwidth down to "
        "50%, overhead up 2x by mid-run) and then heals — no node ever "
        "goes down.",
        probes="Moment drift: the paper's inputs (service moments, Fig. 6) "
        "are treated as known constants; here the true moments move while "
        "availability stays perfect, so only measurement — the EWMA moment "
        "estimator — can reveal the change.",
        expected="static silently degrades (its pi still favors the "
        "now-slow NJ nodes); adaptive's estimated moments drift with the "
        "truth and re-planning shifts traffic toward CA, recovering most "
        "of the gap.",
        drift_nodes=(0, 1, 2, 3),
        overhead_drift=(1.0, 1.0, 1.4, 1.7, 2.0, 2.0, 1.4, 1.0),
        bandwidth_drift=(1.0, 1.0, 0.75, 0.6, 0.5, 0.5, 0.75, 1.0),
    )
)
