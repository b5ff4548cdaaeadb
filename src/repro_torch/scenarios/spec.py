"""Declarative scenario specifications + registry.

The port of ``repro/scenarios/spec.py``. A :class:`ScenarioSpec` is pure
data: a failure trace, an arrival-rate trace, a service-drift trace, and a
re-plan cadence, all expressed per *segment* (the unit at which the closed
loop observes and re-plans, ``storage.simulator.simulate_segment``). The
engine (`engine.py`) expands a spec into the per-segment arrays the
segmented simulator consumes; the schedules stay host float64 / bool
numpy, as in the reference, and only :meth:`ScenarioSpec.objective` builds
tensors (on the device it is asked for).

Registry protocol: `library.py` registers the built-in scenarios at import
time; ``get_scenario(name)`` / ``scenario_names()`` / ``all_scenarios()``
are the lookup surface. The registry is this package's own.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import ObjectiveSpec, make_objective
from repro_torch.storage.cache import CacheModel

# Default catalog: 4 heterogeneous files on the 12-node Tahoe testbed,
# loaded to rho ~ 0.3 aggregate (per-node much higher under optimized
# routing) so failures and crowds bite without destabilizing the queues.
DEFAULT_LAM = (0.045, 0.035, 0.02, 0.015)
DEFAULT_K = (4.0, 4.0, 6.0, 6.0)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One non-stationary experiment, declaratively.

    ``failures`` is a tuple of ``(node, first_segment, last_segment)``
    triples (inclusive): the node is down for exactly those segments.
    ``rate_trace`` multiplies every file's arrival rate per segment.
    ``overhead_drift`` / ``bandwidth_drift`` scale the service parameters
    of ``drift_nodes`` (all nodes when ``None``) per segment, drifting the
    true moments away from what any pre-computed plan assumed.
    ``replan_every`` is the closed-loop cadence: the adaptive policy
    re-solves at segment boundaries ``s`` with ``s % replan_every == 0``.

    Repair (``storage/repair.py``): ``repair_rate`` > 0 switches on the
    reconstruction process — while any placed chunk sits on a down node,
    repair reads run at this aggregate rate (reads/sec), split
    across affected files by lost-chunk share, each a k_i-of-surviving
    fetch injected into the simulation as background load under EVERY
    policy. The adaptive policy additionally folds the repair rows into
    its re-solves (repair-aware re-planning) unless the engine is asked
    for the repair-oblivious ablation.

    Tenant mix (pluggable objective layer, ``core/objectives.py``):
    ``class_id`` assigns each file to a tenant class (``None`` = one
    class); ``class_weight`` weights each class's mean latency in the
    solver objective; ``class_deadline`` / ``class_tail_weight`` add
    per-class tail-probability terms (``P[T_c > d_c]``). The engine builds
    the :class:`~repro_torch.core.ObjectiveSpec` once (:meth:`objective`) and
    threads it through the initial solve, the adaptive replanner, and the
    per-class outcome statistics.

    Geo client fabric (``storage/cluster.py::GeoFabric``): ``sites``
    names the client sites (must match the fabric's, in order) and flips
    the engine onto the geo path. ``mix_trace`` is the per-segment client
    *population* share, (S, C) rows on the simplex — a migrating
    population ("follow the sun") is a row schedule. ``egress_degrade``
    entries ``(storage_site, first, last, rtt_scale, bw_scale)`` degrade
    that DC's *egress* for the inclusive segment window: every
    cross-site pair (client site != the DC) has its overhead multiplied
    by ``rtt_scale`` and bandwidth by ``bw_scale``, while co-located
    clients — inside the DC's LAN — are untouched; no node ever goes
    down. A geo spec may not also declare repair traffic, tenant
    classes, or per-node drift traces (one axis of non-stationarity per
    scenario keeps outcomes attributable).
    """

    name: str
    description: str
    probes: str  # which paper claim / related-work phenomenon this stresses
    expected: str  # qualitative outcome the suite should reproduce
    n_segments: int = 8
    requests_per_segment: int = 2000
    chunk_mb: float = 12.5
    lam: tuple[float, ...] = DEFAULT_LAM
    k: tuple[float, ...] = DEFAULT_K
    theta: float = 2.0
    replan_every: int = 1
    failures: tuple[tuple[int, int, int], ...] = ()
    repair_rate: float = 0.0
    rate_trace: tuple[float, ...] | None = None
    drift_nodes: tuple[int, ...] | None = None
    overhead_drift: tuple[float, ...] | None = None
    bandwidth_drift: tuple[float, ...] | None = None
    class_id: tuple[int, ...] | None = None
    class_weight: tuple[float, ...] | None = None
    class_deadline: tuple[float, ...] | None = None
    class_tail_weight: tuple[float, ...] | None = None
    sites: tuple[str, ...] | None = None
    mix_trace: tuple[tuple[float, ...], ...] | None = None
    egress_degrade: tuple[tuple[str, int, int, float, float], ...] = ()
    # Hot/warm cache tier (storage/cache.py): capacity > 0 puts a
    # replicated hot cache in front of the erasure-coded warm tier.
    # cache_outage windows (first, last), inclusive, take the hot tier
    # down — every request goes to the warm tier at full raw load.
    # file_mb are logical object sizes (default: k_i * chunk_mb).
    cache_capacity_mb: float = 0.0
    cache_hit_latency: float = 0.5
    cache_hot_price: float = 0.0  # $/MB of *provisioned* hot capacity
    cache_outage: tuple[tuple[int, int], ...] = ()
    file_mb: tuple[float, ...] | None = None

    @property
    def r(self) -> int:
        return len(self.lam)

    @property
    def is_geo(self) -> bool:
        return self.sites is not None

    @property
    def n_sites(self) -> int:
        return 0 if self.sites is None else len(self.sites)

    @property
    def has_cache(self) -> bool:
        return self.cache_capacity_mb > 0.0

    def file_bytes(self) -> np.ndarray:
        """(r,) logical object sizes in bytes (default k_i * chunk_mb)."""
        mb = (
            np.asarray(self.k, float) * self.chunk_mb
            if self.file_mb is None
            else np.asarray(self.file_mb, float)
        )
        return mb * float(2**20)

    def cache_model(self) -> CacheModel:
        """The scenario's hot-tier :class:`~repro_torch.storage.cache.CacheModel`."""
        if not self.has_cache:
            raise ValueError(f"{self.name}: no cache tier declared")
        return CacheModel(
            file_bytes=self.file_bytes(),
            capacity_bytes=self.cache_capacity_mb * float(2**20),
            hit_latency=self.cache_hit_latency,
            hot_price_per_mb=self.cache_hot_price,
        )

    def cache_up_trace(self) -> np.ndarray:
        """(S,) bool: hot tier up per segment (False in outage windows)."""
        up = np.ones((self.n_segments,), bool)
        for first, last in self.cache_outage:
            up[first : last + 1] = False
        return up

    @property
    def n_classes(self) -> int:
        for trace in (self.class_weight, self.class_deadline,
                      self.class_tail_weight):
            if trace is not None:
                return len(trace)
        return 1 if self.class_id is None else max(self.class_id) + 1

    def objective(self, device: str | torch.device = "cuda") -> ObjectiveSpec | None:
        """The composed solver objective on ``device``, or None (single
        uniform class)."""
        if all(
            f is None
            for f in (self.class_id, self.class_weight, self.class_deadline,
                      self.class_tail_weight)
        ):
            return None
        cid = (0,) * self.r if self.class_id is None else self.class_id
        return make_objective(
            cid,
            weight=self.class_weight,
            deadline=self.class_deadline,
            tail_weight=self.class_tail_weight,
            device=device,
        )

    def avail_trace(self, m: int) -> np.ndarray:
        """(S, m) bool availability from the failure trace."""
        avail = np.ones((self.n_segments, m), bool)
        for node, first, last in self.failures:
            avail[first : last + 1, node] = False
        return avail

    def rate_scales(self) -> np.ndarray:
        if self.rate_trace is None:
            return np.ones((self.n_segments,))
        return np.asarray(self.rate_trace, float)

    def _drift(self, trace: tuple[float, ...] | None, m: int) -> np.ndarray:
        scales = np.ones((self.n_segments, m))
        if trace is not None:
            cols = (
                list(range(m)) if self.drift_nodes is None else list(self.drift_nodes)
            )
            scales[:, cols] = np.asarray(trace, float)[:, None]
        return scales

    def overhead_scales(self, m: int) -> np.ndarray:
        return self._drift(self.overhead_drift, m)

    def bandwidth_scales(self, m: int) -> np.ndarray:
        return self._drift(self.bandwidth_drift, m)

    def mix_schedule(self) -> np.ndarray:
        """(S, C) client-population share per segment (uniform default)."""
        if self.mix_trace is None:
            return np.full(
                (self.n_segments, self.n_sites), 1.0 / max(self.n_sites, 1)
            )
        return np.asarray(self.mix_trace, float)

    def lam_cs_schedule(self) -> np.ndarray:
        """(S, C, r) per-segment traffic matrices: catalog rates split by
        the population share, then the scenario's global rate trace."""
        mixes = self.mix_schedule()  # (S, C)
        lam = np.asarray(self.lam, float)  # (r,)
        seq = mixes[:, :, None] * lam[None, None, :]
        return seq * self.rate_scales()[:, None, None]

    def egress_scales(self, fabric) -> tuple[np.ndarray, np.ndarray]:
        """(S, C, m) per-pair overhead/bandwidth scales from the egress
        trace: cross-site pairs of a degraded DC pay ``rtt_scale`` /
        ``bw_scale`` for the window; co-located clients are untouched."""
        s, c, m = self.n_segments, fabric.n_sites, fabric.m
        ovh = np.ones((s, c, m))
        bw = np.ones((s, c, m))
        node_site = [nd.site for nd in fabric.cluster.nodes]
        for storage_site, first, last, rtt_scale, bw_scale in self.egress_degrade:
            cols = [j for j, site in enumerate(node_site) if site == storage_site]
            rows = [
                ci for ci, cs in enumerate(fabric.sites)
                if cs.name != storage_site
            ]
            window = slice(first, last + 1)
            for ci in rows:
                for j in cols:
                    ovh[window, ci, j] *= rtt_scale
                    bw[window, ci, j] *= bw_scale
        return ovh, bw

    def validate(self, m: int) -> None:
        for trace, label in (
            (self.rate_trace, "rate_trace"),
            (self.overhead_drift, "overhead_drift"),
            (self.bandwidth_drift, "bandwidth_drift"),
        ):
            if trace is not None and len(trace) != self.n_segments:
                raise ValueError(
                    f"{self.name}: {label} has {len(trace)} entries, "
                    f"need n_segments={self.n_segments}"
                )
        if self.repair_rate < 0:
            raise ValueError(f"{self.name}: repair_rate must be >= 0")
        if self.repair_rate > 0 and not self.failures:
            raise ValueError(
                f"{self.name}: repair_rate > 0 without a failure trace — "
                "nothing would ever need reconstruction"
            )
        for node, first, last in self.failures:
            if not (0 <= node < m):
                raise ValueError(f"{self.name}: failed node {node} not in [0, {m})")
            if not (0 <= first <= last < self.n_segments):
                raise ValueError(
                    f"{self.name}: failure window [{first}, {last}] outside "
                    f"[0, {self.n_segments})"
                )
        # every segment must keep >= max k_i nodes up (degraded reads need
        # a feasible k-of-n subset)
        up = self.avail_trace(m).sum(-1)
        if (up < max(self.k)).any():
            raise ValueError(
                f"{self.name}: some segment leaves fewer than max k nodes up"
            )
        if self.class_id is not None and len(self.class_id) != self.r:
            raise ValueError(
                f"{self.name}: class_id has {len(self.class_id)} entries, "
                f"need one per file (r={self.r})"
            )
        try:
            # delegates per-class shape/value checks (host data: on the CPU)
            self.objective(device="cpu")
        except ValueError as e:
            raise ValueError(f"{self.name}: {e}") from None
        self._validate_cache()
        self._validate_geo()

    def _validate_cache(self) -> None:
        if self.cache_capacity_mb < 0 or self.cache_hit_latency < 0 or (
            self.cache_hot_price < 0
        ):
            raise ValueError(
                f"{self.name}: cache capacity/hit latency/price must be >= 0"
            )
        if self.file_mb is not None:
            if len(self.file_mb) != self.r:
                raise ValueError(
                    f"{self.name}: file_mb has {len(self.file_mb)} entries, "
                    f"need one per file (r={self.r})"
                )
            if any(v <= 0 for v in self.file_mb):
                raise ValueError(f"{self.name}: file_mb sizes must be > 0")
        if not self.has_cache:
            if self.cache_outage:
                raise ValueError(
                    f"{self.name}: cache_outage without a cache tier "
                    "(set cache_capacity_mb > 0)"
                )
            return
        if self.is_geo:
            raise ValueError(
                f"{self.name}: cache scenarios do not compose with a geo "
                "fabric yet (one axis of non-stationarity per scenario)"
            )
        if self.repair_rate > 0:
            raise ValueError(
                f"{self.name}: cache scenarios do not compose with repair "
                "traffic (keep hot/warm attribution clean); the replanner-"
                "level interaction is covered by unit tests"
            )
        for first, last in self.cache_outage:
            if not (0 <= first <= last < self.n_segments):
                raise ValueError(
                    f"{self.name}: cache outage window [{first}, {last}] "
                    f"outside [0, {self.n_segments})"
                )

    def _validate_geo(self) -> None:
        if not self.is_geo:
            if self.mix_trace is not None or self.egress_degrade:
                raise ValueError(
                    f"{self.name}: mix_trace/egress_degrade need `sites`"
                )
            return
        for field, label in (
            (self.class_id, "tenant classes"),
            (self.overhead_drift, "overhead_drift"),
            (self.bandwidth_drift, "bandwidth_drift"),
        ):
            if field is not None:
                raise ValueError(
                    f"{self.name}: geo scenarios cannot also declare {label} "
                    "(egress_degrade expresses per-pair drift; one axis of "
                    "non-stationarity per scenario)"
                )
        if self.repair_rate > 0:
            raise ValueError(
                f"{self.name}: geo scenarios do not compose with repair "
                "traffic yet"
            )
        if self.mix_trace is not None:
            mixes = np.asarray(self.mix_trace, float)
            if mixes.shape != (self.n_segments, self.n_sites):
                raise ValueError(
                    f"{self.name}: mix_trace must be (n_segments, n_sites) "
                    f"= ({self.n_segments}, {self.n_sites}), got {mixes.shape}"
                )
            if (mixes < 0).any() or not np.allclose(mixes.sum(-1), 1.0, atol=1e-6):
                raise ValueError(
                    f"{self.name}: every mix_trace row must be a "
                    "distribution over client sites"
                )
        for storage_site, first, last, rtt_scale, bw_scale in self.egress_degrade:
            if not (0 <= first <= last < self.n_segments):
                raise ValueError(
                    f"{self.name}: egress window [{first}, {last}] outside "
                    f"[0, {self.n_segments})"
                )
            if rtt_scale < 1.0 or not (0.0 < bw_scale <= 1.0):
                raise ValueError(
                    f"{self.name}: egress degradation must slow the path "
                    "(rtt_scale >= 1, 0 < bw_scale <= 1)"
                )

    def validate_geo_fabric(self, fabric) -> None:
        """Geo checks that need the fabric: site names must line up."""
        if not self.is_geo:
            raise ValueError(f"{self.name} is not a geo scenario")
        if tuple(self.sites) != fabric.site_names:
            raise ValueError(
                f"{self.name}: sites {self.sites} do not match the "
                f"fabric's {fabric.site_names}"
            )
        storage_sites = {nd.site for nd in fabric.cluster.nodes}
        for storage_site, *_ in self.egress_degrade:
            if storage_site not in storage_sites:
                raise ValueError(
                    f"{self.name}: egress_degrade names unknown storage "
                    f"site {storage_site!r}"
                )

    def scaled(self, factor: float, min_requests: int = 200) -> "ScenarioSpec":
        """Same scenario at a reduced request volume (CI smoke / tests)."""
        n = max(min_requests, int(self.requests_per_segment * factor))
        return dataclasses.replace(self, requests_per_segment=n)


_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(scenario_names())}"
        ) from None


def scenario_names() -> list[str]:
    return sorted(_REGISTRY)


def all_scenarios() -> list[ScenarioSpec]:
    return [_REGISTRY[n] for n in scenario_names()]


def diurnal_trace(n_segments: int, low: float = 0.6, high: float = 1.6) -> tuple:
    """One full sine period across the schedule (a compressed day)."""
    mid, amp = (high + low) / 2.0, (high - low) / 2.0
    return tuple(
        mid + amp * math.sin(2.0 * math.pi * s / n_segments)
        for s in range(n_segments)
    )
