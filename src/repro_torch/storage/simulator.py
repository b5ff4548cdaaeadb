"""Exact discrete-event simulation of probabilistic scheduling.

Under probabilistic scheduling each node runs an independent FCFS queue, so
the whole system reduces to one scan over the merged arrival stream with
per-node last-departure state (`kernels/fcfs_queue.py`):

    start_j  = max(t_req, dep_j)            (FCFS, work-conserving)
    finish_j = start_j + service_j
    dep_j   <- finish_j  where node j was selected for this request
    file latency = max_{j in A} finish_j - t_req

This is an exact simulation of Def. 2, used to validate the Lemma-2/3
bound. :func:`simulate` runs one system; :func:`simulate_fleet` runs a
batch of independent seeds as ONE (S, m)-wide scan (the what-if ensemble
shape). Randomness comes from a ``torch.Generator`` on the simulated
device, or from explicit :class:`SimDraws`, which is how the tests feed
the reference's own draws. ``simulate(sketch=...)`` also folds the run's
latencies into streaming moments and a quantile sketch
(``storage/streaming.py``), the surface the Fig. 10-12 CDF checks read.
:func:`per_class_latency_stats` and :func:`simulate_latency_cdf` are
host-side reporting.

Non-stationary runs (the closed loop's surface): :func:`simulate_segment`
runs one *segment* of requests against a node-availability mask, an
arrival-rate scale and a service drift, threading the FCFS queue state
(:class:`SimCarry`) across segment boundaries so that a schedule of
segments is one continuous history. A Madow-selected node that is down is
replaced by the available spares with the highest priority draw (a
degraded read keeps the k-of-n read size: any k chunks decode). Each
segment reports per-node service observations (:class:`NodeObservations`)
for a moment estimator. :func:`simulate_segments` runs a whole schedule as
a loop over segments on the device (one B1 launch a segment, no host sync
between them). Geo segments draw each request's service from its origin
site's row; candidate rollouts (:func:`run_segment_batch`) run B plans x K
draws from one carried state as ONE B1 launch under common random numbers.

Hot/warm cache tier (`storage/cache.py`): every segment entry point and
the fleet take an optional per-file TTL vector; the merged arrival stream
first runs through the TTL-with-reset cache and only the misses reach
dispatch and the FCFS queues — hits return at the hot tier's latency. The
cache warmth rides in :class:`SimCarry` beside the queue state; TTLs all
zero are bitwise the cache-free run.

The streaming fleet (``simulate_fleet(stream=True, n_chunks=W)``) walks W
chunks of requests, each one B1 launch with the carried ``dep``, ``busy``,
clock and cache warmth, and folds each chunk into constant-size streaming
statistics, so the horizon no longer sets the memory.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch import diag
from repro_torch.core.scheduling import madow_sample
from repro_torch.kernels.fcfs_queue import fcfs_scan

from .cache import ttl_cache_scan
from .cluster import Cluster, GeoFabric, _device
from .streaming import (
    DEFAULT_SKETCH,
    SketchSpec,
    StreamingStats,
    stream_from_values,
    stream_init,
    stream_mean,
    stream_merge,
    stream_quantile,
    stream_reduce,
    windowed_quantile_mean,
)


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, Tensor) else x)


class ClassLatencyStats(NamedTuple):
    """Per-tenant-class empirical latency statistics (host-side reporting).

    Shapes are all (C,). A class that received no (post-warmup) request
    gets NaN mean and quantiles and count 0.
    """

    count: np.ndarray  # requests observed per class
    mean: np.ndarray  # empirical mean latency
    p95: np.ndarray  # empirical 95th percentile
    p99: np.ndarray  # empirical 99th percentile


def per_class_latency_stats(
    latency, file_id, class_of_file, n_classes: int
) -> ClassLatencyStats:
    """Group simulated request latencies by class.

    ``class_of_file`` maps file id -> class id. Host-side numpy (tensors
    are copied to the host); arrays may carry leading axes, flattened here.
    """
    latency = _host(latency).ravel()
    cls = _host(class_of_file)[_host(file_id).ravel()]
    count = np.zeros(n_classes, np.int64)
    mean = np.full(n_classes, np.nan)
    p95 = np.full(n_classes, np.nan)
    p99 = np.full(n_classes, np.nan)
    for c in range(n_classes):
        lat_c = latency[cls == c]
        count[c] = lat_c.size
        if lat_c.size:
            mean[c] = lat_c.mean()
            p95[c], p99[c] = np.percentile(lat_c, [95, 99])
    return ClassLatencyStats(count=count, mean=mean, p95=p95, p99=p99)


class SimDraws(NamedTuple):
    """The random inputs of a run; leading axes (N,) or (S, N), and a chunk,
    segment or draw axis in front where an entry point loops over one.

    ``arrival`` counts from the start of the run: absolute for
    :func:`simulate` and the materialized fleet, relative to the carried
    clock for a segment or a stream chunk.
    """

    arrival: Tensor  # arrival times
    file_id: Tensor  # int64 file marks
    u: Tensor  # one U[0, 1) Madow uniform per request
    exp: Tensor  # (..., N, m) unit exponentials for the service draws
    site_id: Tensor | None = None  # int64 client-site marks (fleet, geo)
    prio: Tensor | None = None  # (..., N, m) U[0, 1) spare priorities (segments)

    def at(self, i: int) -> "SimDraws":
        """The draws of entry ``i`` of the leading axis."""
        return SimDraws(*(None if x is None else x[i] for x in self))


class SimResult(NamedTuple):
    latency: Tensor  # (N,) per-request file latency
    file_id: Tensor  # (N,) which file each request was for
    arrival: Tensor  # (N,) arrival times
    node_busy: Tensor  # (m,) total busy seconds per node
    # streaming view of the same latencies, when `simulate` got a sketch
    stream: StreamingStats | None = None

    def mean_latency(self) -> Tensor:
        return torch.mean(self.latency)

    def per_class_stats(self, class_of_file, n_classes: int) -> ClassLatencyStats:
        """Per-class empirical mean/p95/p99; see :func:`per_class_latency_stats`."""
        return per_class_latency_stats(
            self.latency, self.file_id, class_of_file, n_classes
        )

    def per_file_mean(self, r: int) -> Tensor:
        """Mean simulated latency per file, shape (r,).

        Entry ``i`` is the mean over the requests file ``i`` received; a
        file with **zero** requests gets **NaN**, never a 0-count mean.
        """
        tot = torch.zeros(r, dtype=self.latency.dtype, device=self.latency.device)
        tot.index_add_(0, self.file_id, self.latency)
        cnt = torch.bincount(self.file_id, minlength=r).to(tot.dtype)
        return torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0), torch.nan)


class FleetResult(NamedTuple):
    """A fleet of independent simulations, leading axis = seed (S,).

    Two reporting modes:

    * **materialized** (``stream=None``): per-request ``latency`` /
      ``file_id`` / ``site_id`` (S, N) tensors, and ``hit`` (S, N) when a
      cache tier ran.
    * **streaming** (``file_id is None``): constant-size per-seed
      :class:`~.streaming.StreamingStats` in ``stream``, per-chunk stats in
      ``windows`` (S, W), post-warmup ``hit_count`` (S,) when a cache tier
      ran, and ``sketch``, the bin geometry; ``latency`` is kept only when
      the run was asked to keep it (validation).
    """

    latency: Tensor | None  # (S, N), or None in streaming mode
    file_id: Tensor | None  # (S, N), or None in streaming mode
    site_id: Tensor | None  # (S, N), or None in streaming mode
    node_busy: Tensor  # (S, m)
    hit: Tensor | None = None  # (S, N) bool cache hits, or None (no cache)
    stream: StreamingStats | None = None  # (S,)-batched, streaming mode
    windows: StreamingStats | None = None  # (S, W)-batched per-chunk stats
    hit_count: Tensor | None = None  # (S,) post-warmup hits (streaming + cache)
    sketch: SketchSpec | None = None  # bin geometry of stream / windows

    def mean_latency(self) -> Tensor:
        # the stream wins when both exist: keep_latency keeps the warmup
        # region too, a superset of what the accumulators hold
        if self.stream is not None:
            return stream_mean(stream_reduce(self.stream))
        return torch.mean(self.latency)

    def quantile(self, q: float) -> Tensor:
        """Fleet-pooled latency quantile from the streaming sketch (merged
        across seeds, exactly: integer bucket counts add)."""
        if self.stream is None:
            raise ValueError(
                "quantile() needs a streaming run (simulate_fleet(stream="
                "True)); materialized runs expose raw .latency instead"
            )
        return stream_quantile(stream_reduce(self.stream), q, self.sketch)

    def p99_windowed(self, q: float = 0.99) -> Tensor:
        """Mean of per-window (chunk) fleet-pooled sketch quantiles, the
        SLO-dashboard aggregation."""
        if self.windows is None:
            raise ValueError("p99_windowed() needs a streaming run")
        merged = stream_reduce(self.windows, axis=0)  # (W,) pooled per window
        return windowed_quantile_mean(merged, q, self.sketch)

    def per_site_mean(self, n_sites: int) -> Tensor:
        """(C,) mean latency by request origin site; a site that originated
        no request gets NaN, never a 0-count mean. Materialized runs only."""
        if self.site_id is None:
            raise ValueError("per_site_mean() needs a materialized run")
        site = self.site_id.reshape(-1)
        tot = torch.zeros(n_sites, dtype=self.latency.dtype, device=site.device)
        tot.index_add_(0, site, self.latency.reshape(-1))
        cnt = torch.bincount(site, minlength=n_sites).to(tot.dtype)
        return torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0), torch.nan)


def _on(x, device: torch.device, dtype=torch.float32) -> Tensor:
    """``x`` as a tensor on ``device``: host data is copied there, a tensor
    on another device is refused (nothing moves silently)."""
    if isinstance(x, Tensor) and x.device != device:
        raise ValueError(f"tensor on {x.device}, the simulated system is on {device}")
    return torch.as_tensor(x, dtype=dtype, device=device)


def _workload(
    generator: torch.Generator, lam_cs: Tensor, shape: tuple[int, ...]
) -> tuple[Tensor, Tensor, Tensor]:
    """Merged Poisson stream over (site, file) pairs, batched over ``shape``'s
    leading axes; the request axis is last."""
    r = lam_cs.shape[-1]
    flat = lam_cs.reshape(-1)
    dev = lam_cs.device
    gaps = torch.empty(shape, dtype=torch.float32, device=dev)
    t = torch.cumsum(gaps.exponential_(generator=generator) / torch.sum(flat), -1)
    cdf = torch.cumsum(flat / torch.sum(flat), 0)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=dev)
    marks = torch.searchsorted(cdf, u, right=True).clamp_(0, flat.shape[0] - 1)
    return t, marks % r, marks // r


def generate_workload(
    generator: torch.Generator, lam: Tensor, n_requests: int
) -> tuple[Tensor, Tensor]:
    """Merged Poisson stream: arrival times (N,) + file ids (N,).

    Superposition of per-file Poisson(lambda_i) == Poisson(sum lambda) with
    iid categorical file marks (probability lambda_i / sum).
    """
    t, file_id, _ = _workload(generator, lam[None, :], (n_requests,))
    return t, file_id


def generate_geo_workload(
    generator: torch.Generator, lam_cs: Tensor, n_requests: int
) -> tuple[Tensor, Tensor, Tensor]:
    """Merged Poisson stream over (client site, file) pairs.

    ``lam_cs`` is (C, r). Marks are drawn by inverse-CDF search (one
    uniform + a ``searchsorted`` into the C*r-bin CDF per request).
    Returns ``(t, file_id, site_id)``, each (N,).
    """
    return _workload(generator, lam_cs, (n_requests,))


def _draw(
    generator: torch.Generator,
    lam_cs: Tensor,
    shape: tuple[int, ...],
    m: int,
    prio: bool = False,
) -> SimDraws:
    t, file_id, site_id = _workload(generator, lam_cs, shape)
    dev = lam_cs.device
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=dev)
    exp = torch.empty(shape + (m,), dtype=torch.float32, device=dev)
    exp.exponential_(generator=generator)
    pr = None
    if prio:
        pr = torch.rand(shape + (m,), generator=generator, dtype=torch.float32, device=dev)
    return SimDraws(t, file_id, u, exp, site_id, pr)


def _check_generator(generator: torch.Generator | None, device: torch.device):
    if generator is None:
        raise ValueError("pass a torch.Generator or explicit draws")
    if generator.device != device:
        raise ValueError(
            f"generator is on {generator.device}, the simulated system on {device}"
        )


def segment_draws(
    generator: torch.Generator,
    lam_cs: Tensor,
    n_requests: int,
    m: int,
    n_draws: int | None = None,
) -> SimDraws:
    """Fresh segment draws at rates ``lam_cs`` (C, r) (one row: no client
    sites), spare priorities included: leading (N,), or (n_draws, N). What
    :func:`run_segment_raw` and the candidate runners draw for themselves;
    a replanner draws once and hands the same draws to every candidate."""
    _check_generator(generator, lam_cs.device)
    shape = (n_requests,) if n_draws is None else (n_draws, n_requests)
    return _draw(generator, lam_cs, shape, m, prio=True)


def _draws_for(
    generator, draws: SimDraws | None, lam_cs: Tensor, shape, m: int, prio: bool
) -> SimDraws:
    """The run's draws: ``draws`` as given, else fresh from ``generator``."""
    if draws is None:
        _check_generator(generator, lam_cs.device)
        return _draw(generator, lam_cs, tuple(shape), m, prio)
    if prio and draws.prio is None:
        raise ValueError("segment draws need prio, the spare-priority uniforms")
    return draws


def simulate(
    generator: torch.Generator | None,
    pi: Tensor,
    lam: Tensor,
    cluster: Cluster,
    chunk_mb: float | Tensor,
    n_requests: int = 20000,
    *,
    drop_warmup: float = 0.1,
    per_file_chunk_mb: Tensor | None = None,
    sketch: SketchSpec | None = None,
    draws: SimDraws | None = None,
) -> SimResult:
    """Simulate probabilistic scheduling for dispatch matrix ``pi`` (r, m).

    Runs on ``cluster.device``. ``per_file_chunk_mb`` (r,) gives
    heterogeneous per-file chunk sizes (the §V.B catalog). ``sketch`` also
    folds the post-warmup latencies into ``SimResult.stream``. ``draws``
    replaces the generator's draws (arrivals, file marks, Madow uniforms,
    unit exponentials), each with a leading (N,) axis.
    """
    dev = cluster.device
    pi = _on(pi, dev)
    lam = _on(lam, dev)
    r, m = pi.shape
    if m != cluster.m:
        raise ValueError(f"pi has {m} nodes, the cluster {cluster.m}")
    draws = _draws_for(generator, draws, lam[None, :], (n_requests,), m, False)
    if per_file_chunk_mb is not None:
        chunk = _on(per_file_chunk_mb, dev)[draws.file_id][:, None]
    else:
        chunk = chunk_mb
    d, rate = cluster.service_params(chunk)
    service = d + draws.exp / rate
    masks = madow_sample(draws.u, pi[draws.file_id])
    latency, _, busy = fcfs_scan(draws.arrival, masks, service)
    warm = int(draws.arrival.shape[-1] * drop_warmup)
    latency = latency[warm:]
    return SimResult(
        latency=latency,
        file_id=draws.file_id[warm:],
        arrival=draws.arrival[warm:],
        node_busy=busy,
        stream=None if sketch is None else stream_from_values(latency, sketch),
    )


def simulate_latency_cdf(result: SimResult, qs: np.ndarray | None = None):
    """Empirical CDF knots ``(qs, quantiles)`` of a run's latencies, host
    numpy (Fig. 10-style output); ``qs`` defaults to 0.01..0.99."""
    qs = np.linspace(0.01, 0.99, 99) if qs is None else qs
    return qs, np.quantile(_host(result.latency), qs)


# ---------------------------------------------------------------------------
# Segmented (non-stationary) simulation: failures, flash crowds, drift.
# ---------------------------------------------------------------------------


class NodeObservations(NamedTuple):
    """Per-node service-time measurements from one segment.

    ``count`` chunks served per node plus raw power sums of the observed
    service times — what a node-side agent reports to a control plane, and
    enough for unbiased estimates of the first three raw moments Lemma 3
    needs. Nodes that served nothing (down, or no dispatch mass) have
    ``count == 0``.
    """

    count: Tensor  # (m,) int32 chunks served
    s1: Tensor  # (m,) sum of service times
    s2: Tensor  # (m,) sum of squares
    s3: Tensor  # (m,) sum of cubes


class SimCarry(NamedTuple):
    """FCFS queue state threaded across segment boundaries.

    ``cache`` is the hot-tier cache state — per-file absolute expiry times
    (`storage/cache.py`) — or None when no cache tier is simulated. Cache
    warmth, like queue depth, is history that must survive a boundary.
    """

    dep: Tensor  # (m,) last scheduled departure per node
    t0: Tensor  # () absolute clock at the segment boundary
    cache: Tensor | None = None  # (r,) per-file expiry times, or None


class SegmentResult(NamedTuple):
    latency: Tensor  # (N,) per-request file latency
    file_id: Tensor  # (N,)
    arrival: Tensor  # (N,) absolute arrival times
    node_busy: Tensor  # (m,) busy seconds added this segment
    degraded: Tensor  # (N,) bool: >= 1 selected node was down (read fell back)
    obs: NodeObservations
    t_end: Tensor  # () absolute time of the last arrival
    hit: Tensor | None = None  # (N,) bool cache hits, or None (no cache tier)

    def mean_latency(self) -> Tensor:
        return torch.mean(self.latency)


class GeoSegmentResult(NamedTuple):
    """One geo segment: like :class:`SegmentResult` plus the client axis.

    ``site_id`` records each request's origin site; ``obs`` carries
    per-(site, node) sums, every field (C, m).
    """

    latency: Tensor  # (N,)
    file_id: Tensor  # (N,)
    site_id: Tensor  # (N,) request origin client site
    arrival: Tensor  # (N,) absolute arrival times
    node_busy: Tensor  # (m,) busy seconds added this segment
    degraded: Tensor  # (N,) bool
    obs: NodeObservations  # per-(site, node): every field (C, m)
    t_end: Tensor  # ()

    def mean_latency(self) -> Tensor:
        return torch.mean(self.latency)


def init_carry(
    m: int,
    *,
    cache_files: int | None = None,
    device: str | torch.device = "cuda",
) -> SimCarry:
    """Fresh carry on ``device``: idle queues and — when ``cache_files`` is
    given — a cold hot-tier cache over that many files (expiries -inf)."""
    dev = _device(device)
    f32 = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=dev)
    cache = None if cache_files is None else f32((cache_files,), -torch.inf)
    return SimCarry(dep=f32((m,), 0.0), t0=f32((), 0.0), cache=cache)


def _spare_fill(
    sel: Tensor, k_req: Tensor, prio: Tensor, avail: Tensor
) -> tuple[Tensor, Tensor]:
    """Replace selected-but-down nodes by the available spares with the
    highest priority, keeping the read at ``k_req`` nodes where it can.

    ``sel`` (..., m) Madow sets, ``k_req`` (...) read sizes, ``prio``
    broadcastable to ``sel``. Ranks are the reference's
    ``argsort(argsort(-score))`` with stable sorts.
    """
    alive = sel & avail
    need = k_req - torch.sum(alive, dim=-1)
    cand = avail & ~sel
    score = torch.where(cand, prio, -1.0)
    rank = torch.argsort(torch.argsort(-score, dim=-1, stable=True), dim=-1, stable=True)
    # when need exceeds the candidate pool (thin availability) every
    # available unselected node joins: the union is then exactly `avail`
    add = cand & (rank < need[..., None])
    return alive | add, torch.any(sel & ~avail, dim=-1)


def dispatch_masks(
    u: Tensor, prio: Tensor, pi: Tensor, file_id: Tensor, avail: Tensor
) -> tuple[Tensor, Tensor]:
    """Per-request service sets under the availability mask ``avail`` (m,).

    Each request Madow-samples its k_i-subset of ``pi[file_id]`` with its
    uniform ``u`` (exact Theorem-1 marginals). Selected-but-down nodes are
    then replaced by the available spares whose priority draw ``prio``
    (..., N, m) is highest, keeping the read size k_i: a degraded read (any
    k chunks of an (n, k) MDS code decode).

    Returns ``(masks, degraded)``: (..., N, m) bool service sets and
    (..., N) bool flags marking requests whose Madow set hit a down node.
    Under thin availability (fewer than k_i nodes up) the service set is
    exactly ``avail`` and the request is flagged degraded, the convention
    ``storage/repair.py`` follows too. ``pi`` may be a (B, r, m) stack of
    candidate plans on common draws; the results then gain a leading (B,)
    axis.
    """
    avail = torch.as_tensor(avail, dtype=torch.bool, device=pi.device)
    k_per_file = torch.round(torch.sum(pi, dim=-1)).to(torch.int64)
    sel = madow_sample(u, pi[..., file_id, :])
    return _spare_fill(sel, k_per_file[..., file_id], prio, avail)


class _Shards:
    """A leading axis of ``n`` rows (fleet seeds, rollout lanes) split over
    ``devices``: padded up to a multiple of their count by replaying the
    first rows, one contiguous block a device. Rows go out from, and come
    back to, ``home``, the device the inputs live on; a block already on
    its device is not copied. Device-to-device copies do not sync the host,
    so this runs inside the guarded hot paths (``diag.py``)."""

    def __init__(self, devices, n: int, home: torch.device):
        self.devices, self.n, self.home = [torch.device(d) for d in devices], n, home
        self.per = -(-n // len(self.devices))
        run = self.per * len(self.devices)
        self.idx = None if run == n else torch.arange(run, device=home) % n

    def split(self, x: Tensor) -> list[Tensor]:
        if self.idx is not None:
            x = x[self.idx]
        return [b.to(d, non_blocking=True) for b, d in zip(torch.split(x, self.per), self.devices)]

    def gather(self, blocks) -> Tensor:
        return torch.cat([b.to(self.home, non_blocking=True) for b in blocks])[: self.n]


def _scan_split(shards: _Shards | None, t, masks, service, dep0=None, busy0=None):
    """B1 with its rows split by ``shards``: one launch a device on its
    block. ``t``, ``masks`` and ``service`` are full rows on the home
    device; ``dep0`` and ``busy0`` full rows too, or already one block a
    device (a carried state), or None (idle queues). Returns (latency
    gathered home, [dep a device], [busy a device]): each row bitwise what
    one launch over all rows gives it. With ``shards`` None: one launch,
    and dep and busy as it returns them."""
    if shards is None:
        return fcfs_scan(t, masks, service, dep0, busy0)
    blocks = lambda x: [None] * len(shards.devices) if x is None else (
        x if isinstance(x, list) else shards.split(x))
    outs = [fcfs_scan(*a) for a in zip(*(blocks(x) for x in (t, masks, service, dep0, busy0)))]
    return shards.gather([o[0] for o in outs]), [o[1] for o in outs], [o[2] for o in outs]


def _gathered(shards: _Shards | None, state):
    """A state from :func:`_scan_split` on the home device."""
    return state if shards is None else shards.gather(state)


def _scan(
    arrival: Tensor, serve: Tensor, service: Tensor, dep0: Tensor, devices=None
) -> tuple[Tensor, Tensor, Tensor]:
    """B1 over the leading axes of ``serve`` as ONE launch; ``arrival``,
    ``service`` and ``dep0`` broadcast against them (common draws).
    ``devices`` (several) split the flattened rows over them instead, one
    launch a device."""
    if serve.dim() == 2:
        return fcfs_scan(arrival, serve, service, dep0)
    lead = serve.shape[:-2]
    n, m = serve.shape[-2:]
    flat = lambda x, *event: x.expand(lead + event).reshape((-1,) + event)
    rows = (flat(arrival, n), serve.reshape((-1, n, m)), flat(service, n, m), flat(dep0, m))
    shards = None if devices is None else _Shards(devices, rows[0].shape[0], serve.device)
    latency, dep, busy = _scan_split(shards, *rows)
    dep, busy = _gathered(shards, dep), _gathered(shards, busy)
    return (latency.reshape(lead + (n,)), dep.reshape(lead + (m,)),
            busy.reshape(lead + (m,)))


def _observations(serve: Tensor, service: Tensor) -> NodeObservations:
    served = torch.where(serve, service, 0.0)
    return NodeObservations(
        count=torch.sum(serve, dim=-2, dtype=torch.int32),
        s1=torch.sum(served, dim=-2),
        s2=torch.sum(served**2, dim=-2),
        s3=torch.sum(served**3, dim=-2),
    )


def _cache_prescan(expiry, t, file_id, ttl, masks):
    """The hot tier in front of the queues: ``(new_expiry, hit, masks)``
    with each hit's service set cleared. A missing ``expiry`` is a cold
    cache (every file expired at -inf); without a ``ttl`` nothing hits and
    ``hit`` is None."""
    if ttl is None:
        return expiry, None, masks
    if expiry is None:
        expiry = torch.full(ttl.shape[-1:], -torch.inf, device=ttl.device)
    new_expiry, hit = ttl_cache_scan(expiry, t, file_id, ttl)
    return new_expiry, hit, masks & ~hit[..., None]


def _run_segment(
    carry: SimCarry,
    draws: SimDraws,
    pi: Tensor,
    overheads: Tensor,
    rates: Tensor,
    avail: Tensor,
    ttl: Tensor | None = None,
    hit_latency: Tensor | float = 0.0,
    devices=None,
) -> tuple[SimCarry, SegmentResult]:
    """One segment on explicit draws; ``pi`` (r, m), or a (B, r, m) stack
    of candidates on common draws with a leading (K,) axis (``devices``:
    B1's (B·K) rows split over them, ``_scan``).

    ``overheads``/``rates`` are the (already drift-scaled) shifted-
    exponential service parameters, ``avail`` the (m,) availability mask.
    In order: arrivals ``t0 + rel`` (float32), the dispatch masks, the cache
    pre-scan (``ttl`` not None: hits leave the masks and the degraded
    flags), B1 from the carried ``dep``, ``hit_latency`` over each hit's
    latency, then the observation sums of what the queues served.
    """
    arrival = carry.t0 + draws.arrival
    service = overheads + draws.exp / rates
    masks, degraded = dispatch_masks(draws.u, draws.prio, pi, draws.file_id, avail)
    new_cache, hit, serve = _cache_prescan(carry.cache, arrival, draws.file_id, ttl, masks)
    if hit is not None:
        degraded = degraded & ~hit
    latency, dep, busy = _scan(arrival, serve, service, carry.dep, devices)
    if hit is not None:
        latency = torch.where(hit, hit_latency, latency)
    new_carry = SimCarry(dep=dep, t0=arrival[..., -1], cache=new_cache)
    return new_carry, SegmentResult(
        latency=latency,
        file_id=draws.file_id,
        arrival=arrival,
        node_busy=busy,
        degraded=degraded,
        obs=_observations(serve, service),
        t_end=arrival[..., -1],
        hit=hit,
    )


def _hit_latency(hit_latency, device: torch.device) -> Tensor:
    """The hit latency as a float32 scalar on ``device``; a Python number
    is filled in there, not copied from the host (rollouts are a guarded
    hot path, ``diag.py``)."""
    if isinstance(hit_latency, Tensor):
        return _on(hit_latency, device)
    return torch.full((), float(hit_latency), dtype=torch.float32, device=device)


def run_segment_raw(
    carry: SimCarry,
    generator: torch.Generator | None,
    pi: Tensor,
    lam: Tensor,
    overheads: Tensor,
    rates: Tensor,
    avail: Tensor,
    n_requests: int,
    ttl: Tensor | None = None,
    hit_latency: Tensor | float = 0.0,
    *,
    draws: SimDraws | None = None,
) -> tuple[SimCarry, SegmentResult]:
    """One segment from explicit shifted-exponential service parameters (no
    Cluster object): the surface control-plane code rolls candidate plans
    out on from *estimated* parameters. Runs where ``pi`` lives; ``draws``
    (leading (N,), ``prio`` set, arrivals relative to ``carry.t0``)
    replace the generator's draws at rates ``lam``."""
    dev = pi.device
    draws = _draws_for(generator, draws, lam[None, :], (n_requests,), pi.shape[-1], True)
    return _run_segment(
        carry, draws, pi, overheads, rates, avail, ttl, _hit_latency(hit_latency, dev)
    )


def simulate_segment(
    generator: torch.Generator | None,
    pi: Tensor,
    lam: Tensor,
    cluster: Cluster,
    chunk_mb: float,
    n_requests: int,
    *,
    avail: Tensor | None = None,
    rate_scale: float | Tensor = 1.0,
    overhead_scale: float | Tensor = 1.0,
    bandwidth_scale: float | Tensor = 1.0,
    carry: SimCarry | None = None,
    cache_ttl: Tensor | None = None,
    cache_hit_latency: float = 0.0,
    draws: SimDraws | None = None,
) -> tuple[SegmentResult, SimCarry]:
    """Simulate one segment against a possibly-perturbed cluster state.

    The caller owns ``pi`` (and may re-plan it between segments) while the
    queue state persists in ``carry``. ``rate_scale`` multiplies arrival
    rates — a scalar scales every file, an (r,) vector scales per file
    (e.g. switching repair rows on and off, `storage/repair.py`).
    ``overhead_scale`` / ``bandwidth_scale`` (scalar or (m,)) drift the
    service parameters. ``cache_ttl`` (r,) switches on the hot-tier cache
    in front of the queues (zeros mark uncached files; warmth persists in
    ``carry``). Runs on ``cluster.device``; ``draws`` as in
    :func:`run_segment_raw`.
    """
    dev = cluster.device
    m = cluster.m
    avail = torch.ones((m,), dtype=torch.bool, device=dev) if avail is None else _on(
        avail, dev, torch.bool)
    ttl = None if cache_ttl is None else _on(cache_ttl, dev)
    carry = init_carry(m, device=dev) if carry is None else carry
    overheads = cluster.overheads() * _on(overhead_scale, dev)
    rates = cluster.bandwidths() * _on(bandwidth_scale, dev) / _on(chunk_mb, dev)
    lam_s = _on(lam, dev) * _on(rate_scale, dev)
    new_carry, res = run_segment_raw(
        carry, generator, _on(pi, dev), lam_s, overheads, rates, avail, n_requests,
        ttl, cache_hit_latency, draws=draws,
    )
    return res, new_carry


def _stack(results: list):
    """Stack a list of per-segment results along a new leading axis."""
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    first = results[0]
    fields = {}
    for name in first._fields:
        if name == "obs":
            fields[name] = NodeObservations(
                *(torch.stack(f) for f in zip(*(res.obs for res in results))))
        else:
            fields[name] = stack([getattr(res, name) for res in results])
    return type(first)(**fields)


def _segment_count(*candidates) -> int:
    n_seg = None
    for cand in candidates:
        if cand is None:
            continue
        if n_seg is None:
            n_seg = int(cand)
        elif n_seg != int(cand):
            raise ValueError(f"inconsistent segment counts: {n_seg} vs {int(cand)}")
    if n_seg is None:
        raise ValueError(
            "cannot infer the segment count: pass a (S, r, m) pi_seq or any "
            "per-segment sequence"
        )
    return n_seg


def _lead(seq):
    return None if seq is None else np.shape(seq)[0]


def simulate_segments(
    generator: torch.Generator | None,
    pi_seq: Tensor,
    lam: Tensor,
    cluster: Cluster,
    chunk_mb: float,
    n_requests: int,
    *,
    avail_seq: Tensor | None = None,
    rate_scale_seq: Tensor | None = None,
    overhead_scale_seq: Tensor | None = None,
    bandwidth_scale_seq: Tensor | None = None,
    cache_ttl_seq: Tensor | None = None,
    cache_hit_latency: float = 0.0,
    draws: SimDraws | None = None,
) -> SegmentResult:
    """Run a whole segment schedule from idle queues as one device loop.

    ``pi_seq`` is (S, r, m) — or (r, m), broadcast to every segment — and
    the optional per-segment sequences are ``avail_seq`` (S, m) bool,
    ``rate_scale_seq`` (S,) — or (S, r) per file, which switches repair
    rows on in outage segments only — ``overhead_scale_seq`` /
    ``bandwidth_scale_seq`` (S,) or (S, m), and ``cache_ttl_seq`` (S, r)
    or (r,) (an all-zero row is a hot-tier outage: nothing hits, and the
    cache drains). Each segment is one B1 launch from the carried state,
    with no host sync between segments; every field of the returned
    :class:`SegmentResult` gains a leading (S,) axis. ``draws`` carries a
    leading (S,) segment axis. The same schedule as a host loop of
    :func:`simulate_segment` on the same draws is bitwise this.
    """
    dev = cluster.device
    m = cluster.m
    pi_seq = _on(pi_seq, dev)
    n_seg = _segment_count(
        pi_seq.shape[0] if pi_seq.dim() == 3 else None,
        _lead(rate_scale_seq), _lead(avail_seq), _lead(overhead_scale_seq),
        _lead(bandwidth_scale_seq), None if draws is None else draws.arrival.shape[0],
    )
    rate_scale_seq = (torch.ones((n_seg,), device=dev) if rate_scale_seq is None
                      else _on(rate_scale_seq, dev))
    if pi_seq.dim() == 2:
        pi_seq = pi_seq.expand((n_seg,) + tuple(pi_seq.shape))
    avail_seq = (torch.ones((n_seg, m), dtype=torch.bool, device=dev) if avail_seq is None
                 else _on(avail_seq, dev, torch.bool))

    def scales(seq):
        if seq is None:
            return torch.ones((n_seg, m), device=dev)
        seq = _on(seq, dev)
        return (seq[:, None] if seq.dim() == 1 else seq).expand((n_seg, m))

    overheads_seq = cluster.overheads() * scales(overhead_scale_seq)
    rates_seq = cluster.bandwidths() * scales(bandwidth_scale_seq) / _on(chunk_mb, dev)
    if cache_ttl_seq is not None:
        cache_ttl_seq = _on(cache_ttl_seq, dev)
        if cache_ttl_seq.dim() == 1:
            cache_ttl_seq = cache_ttl_seq.expand((n_seg,) + tuple(cache_ttl_seq.shape))
    lam = _on(lam, dev)
    hit_latency = _hit_latency(cache_hit_latency, dev)
    carry = init_carry(m, device=dev)
    results = []
    for s in range(n_seg):
        seg = _draws_for(generator, None if draws is None else draws.at(s),
                         (lam * rate_scale_seq[s])[None, :], (n_requests,), m, True)
        carry, res = _run_segment(
            carry, seg, pi_seq[s], overheads_seq[s], rates_seq[s], avail_seq[s],
            None if cache_ttl_seq is None else cache_ttl_seq[s], hit_latency,
        )
        results.append(res)
    return _stack(results)


# ---------------------------------------------------------------------------
# Geo-aware segments: per-(client-site, node) service.
# ---------------------------------------------------------------------------


def _run_geo_segment(
    carry: SimCarry,
    draws: SimDraws,
    pi: Tensor,
    overheads_cs: Tensor,
    rates_cs: Tensor,
    avail: Tensor,
    devices=None,
) -> tuple[SimCarry, GeoSegmentResult]:
    """One geo segment: site-dependent service, shared per-node FCFS queues.

    ``overheads_cs`` / ``rates_cs`` are (C, m); each request draws service
    from its origin site's row, but every site contends for the same m
    queues. ``pi`` is one plan or a (B, r, m) candidate stack, as in
    :func:`_run_segment` (``devices`` likewise). Observations come back per
    (site, node).
    """
    c = overheads_cs.shape[0]
    site = draws.site_id
    arrival = carry.t0 + draws.arrival
    service = overheads_cs[site] + draws.exp / rates_cs[site]
    masks, degraded = dispatch_masks(draws.u, draws.prio, pi, draws.file_id, avail)
    latency, dep, busy = _scan(arrival, masks, service, carry.dep, devices)
    site_oh = torch.nn.functional.one_hot(site, c).to(torch.float32)  # (..., N, C)
    served = torch.where(masks, service, 0.0)
    pair = lambda x: torch.einsum("...nc,...nm->...cm", site_oh, x)
    obs = NodeObservations(
        count=pair(masks.to(torch.float32)).to(torch.int32),
        s1=pair(served),
        s2=pair(served**2),
        s3=pair(served**3),
    )
    new_carry = SimCarry(dep=dep, t0=arrival[..., -1])
    return new_carry, GeoSegmentResult(
        latency=latency,
        file_id=draws.file_id,
        site_id=site,
        arrival=arrival,
        node_busy=busy,
        degraded=degraded,
        obs=obs,
        t_end=arrival[..., -1],
    )


def run_geo_segment_raw(
    carry: SimCarry,
    generator: torch.Generator | None,
    pi: Tensor,
    lam_cs: Tensor,
    overheads_cs: Tensor,
    rates_cs: Tensor,
    avail: Tensor,
    n_requests: int,
    *,
    draws: SimDraws | None = None,
) -> tuple[SimCarry, GeoSegmentResult]:
    """The geo twin of :func:`run_segment_raw` (``lam_cs`` (C, r));
    ``draws`` need ``site_id`` and ``prio``."""
    draws = _draws_for(generator, draws, lam_cs, (n_requests,), pi.shape[-1], True)
    if draws.site_id is None:
        raise ValueError("geo draws need site_id")
    return _run_geo_segment(carry, draws, pi, overheads_cs, rates_cs, avail)


def simulate_geo_segment(
    generator: torch.Generator | None,
    pi: Tensor,
    lam_cs: Tensor,
    fabric: GeoFabric,
    chunk_mb: float,
    n_requests: int,
    *,
    avail: Tensor | None = None,
    rate_scale: float | Tensor = 1.0,
    overhead_scale: float | Tensor = 1.0,
    bandwidth_scale: float | Tensor = 1.0,
    carry: SimCarry | None = None,
    draws: SimDraws | None = None,
) -> tuple[GeoSegmentResult, SimCarry]:
    """Host-facing geo segment against a :class:`~.cluster.GeoFabric`.

    ``lam_cs`` is the (C, r) per-site arrival matrix; ``rate_scale``
    multiplies it (scalar, (C, 1) or (C, r)). ``overhead_scale`` /
    ``bandwidth_scale`` broadcast against the fabric's (C, m) profile:
    per-pair drift. Runs on ``fabric.cluster.device``.
    """
    dev = fabric.cluster.device
    m = fabric.m
    avail = torch.ones((m,), dtype=torch.bool, device=dev) if avail is None else _on(
        avail, dev, torch.bool)
    carry = init_carry(m, device=dev) if carry is None else carry
    d, rates = fabric.service_params(chunk_mb)
    overheads = d * _on(overhead_scale, dev)
    rates = rates * _on(bandwidth_scale, dev)
    lam_s = _on(lam_cs, dev) * _on(rate_scale, dev)
    new_carry, res = run_geo_segment_raw(
        carry, generator, _on(pi, dev), lam_s, overheads, rates, avail, n_requests,
        draws=draws,
    )
    return res, new_carry


def simulate_geo_segments(
    generator: torch.Generator | None,
    pi_seq: Tensor,
    lam_cs_seq: Tensor,
    fabric: GeoFabric,
    chunk_mb: float,
    n_requests: int,
    *,
    avail_seq: Tensor | None = None,
    overhead_scale_seq: Tensor | None = None,
    bandwidth_scale_seq: Tensor | None = None,
    draws: SimDraws | None = None,
) -> GeoSegmentResult:
    """A whole geo schedule from idle queues as one device loop.

    ``lam_cs_seq`` is (S, C, r) — the per-segment client mix is folded into
    the rates (follow-the-sun is a row reweighting). ``pi_seq`` is
    (S, r, m) or (r, m) broadcast; the scale sequences broadcast to
    (S, C, m). One B1 launch a segment; fields gain a leading (S,) axis.
    """
    dev = fabric.cluster.device
    lam_cs_seq = _on(lam_cs_seq, dev)
    if lam_cs_seq.dim() != 3:
        raise ValueError(f"lam_cs_seq must be (S, C, r), got shape {tuple(lam_cs_seq.shape)}")
    n_seg = lam_cs_seq.shape[0]
    m, c = fabric.m, fabric.n_sites
    pi_seq = _on(pi_seq, dev)
    if pi_seq.dim() == 2:
        pi_seq = pi_seq.expand((n_seg,) + tuple(pi_seq.shape))
    avail_seq = (torch.ones((n_seg, m), dtype=torch.bool, device=dev) if avail_seq is None
                 else _on(avail_seq, dev, torch.bool))

    def scales(seq):
        if seq is None:
            return torch.ones((n_seg, c, m), device=dev)
        return _on(seq, dev).expand((n_seg, c, m))

    d, rates = fabric.service_params(chunk_mb)
    overheads_seq = d * scales(overhead_scale_seq)
    rates_seq = rates * scales(bandwidth_scale_seq)
    carry = init_carry(m, device=dev)
    results = []
    for s in range(n_seg):
        seg = _draws_for(generator, None if draws is None else draws.at(s),
                         lam_cs_seq[s], (n_requests,), m, True)
        carry, res = _run_geo_segment(
            carry, seg, pi_seq[s], overheads_seq[s], rates_seq[s], avail_seq[s])
        results.append(res)
    return _stack(results)


# ---------------------------------------------------------------------------
# Candidate-batched rollouts: every candidate plan (x every rollout draw)
# simulated by ONE B1 launch — the replanner's arbitration surface.
# ---------------------------------------------------------------------------


def _candidate_result(res, b: int):
    """Give the fields that come from the shared draws (file marks, arrivals,
    hits) a leading (B,) candidate axis, like every other field."""
    shared = ("file_id", "site_id", "arrival", "t_end", "hit")
    return res._replace(**{
        f: getattr(res, f).expand((b,) + tuple(getattr(res, f).shape))
        for f in shared if f in res._fields and getattr(res, f) is not None})


def run_segment_batch(
    carry: SimCarry,
    generator: torch.Generator | None,
    pi_stack: Tensor,
    lam: Tensor,
    overheads: Tensor,
    rates: Tensor,
    avail: Tensor,
    n_requests: int,
    ttl: Tensor | None = None,
    hit_latency: Tensor | float = 0.0,
    *,
    n_draws: int = 1,
    draws: SimDraws | None = None,
    devices=None,
) -> SegmentResult:
    """Roll a (B, r, m) stack of candidate plans out from ONE queue state.

    Every candidate sees the same K draws (common random numbers: the same
    arrivals, service draws, Madow and spare uniforms), so score
    differences are plan differences, and with K = 1 each candidate's
    stream is bitwise the one :func:`run_segment_raw` gives that plan
    alone. The B x K systems run as ONE B1 launch over (B·K, N, m) from
    the carried ``dep``; the cache pre-scan, which does not depend on the
    plan, runs once per draw. Every field gains leading (B, K) axes; the
    carry is not advanced (rollouts are hypothetical). ``draws`` has a
    leading (K,) axis; else ``n_draws`` sets K. ``devices`` (a list of
    several) split the B·K systems' rows over them, one B1 launch a device;
    everything else runs where the inputs are.
    """
    dev = pi_stack.device
    draws = _draws_for(generator, draws, lam[None, :], (n_draws, n_requests),
                       pi_stack.shape[-1], True)
    _, res = _run_segment(
        carry, draws, pi_stack, overheads, rates, avail, ttl, _hit_latency(hit_latency, dev),
        devices,
    )
    return _candidate_result(res, pi_stack.shape[0])


def run_geo_segment_batch(
    carry: SimCarry,
    generator: torch.Generator | None,
    pi_stack: Tensor,
    lam_cs: Tensor,
    overheads_cs: Tensor,
    rates_cs: Tensor,
    avail: Tensor,
    n_requests: int,
    *,
    n_draws: int = 1,
    draws: SimDraws | None = None,
    devices=None,
) -> GeoSegmentResult:
    """Geo twin of :func:`run_segment_batch`: (B, K) rollouts of
    :func:`run_geo_segment_raw` under common random numbers, one B1 launch
    (one a device over ``devices``)."""
    draws = _draws_for(generator, draws, lam_cs, (n_draws, n_requests),
                       pi_stack.shape[-1], True)
    if draws.site_id is None:
        raise ValueError("geo draws need site_id")
    _, res = _run_geo_segment(carry, draws, pi_stack, overheads_cs, rates_cs, avail, devices)
    return _candidate_result(res, pi_stack.shape[0])


# ---------------------------------------------------------------------------
# Fleet-scale simulation: many independent systems in one program.
# ---------------------------------------------------------------------------


def _fleet_inputs(draws: SimDraws, pi, overheads_cs, rates_cs, ttl=None, t0=None,
                  cache=None):
    """One batch of merged request streams: arrivals (``t0`` + the relative
    draws, or the draws as they are), marks, service draws, Madow service
    sets and — with a hot tier — the cache hits thinned out of the masks.
    Every site shares one hot tier keyed by file."""
    t = draws.arrival if t0 is None else t0[..., None] + draws.arrival
    site = draws.site_id
    service = overheads_cs[site] + draws.exp / rates_cs[site]
    masks = madow_sample(draws.u, pi[draws.file_id])
    new_cache, hit, masks = _cache_prescan(cache, t, draws.file_id, ttl, masks)
    return t, draws.file_id, site, masks, service, hit, new_cache


def _fleet_one(draws, pi, overheads_cs, rates_cs, warm, ttl=None, hit_latency=0.0,
               shards: _Shards | None = None):
    t, file_id, site_id, masks, service, hit, _ = _fleet_inputs(
        draws, pi, overheads_cs, rates_cs, ttl)
    # busy accrues in the scan's carry, not per step: an (N, m) busy output
    # would dominate the kernel's memory traffic
    latency, _, busy = _scan_split(shards, t, masks, service)  # one B1 launch a device
    busy = _gathered(shards, busy)
    if hit is not None:
        latency = torch.where(hit, hit_latency, latency)
    return (latency[..., warm:], file_id[..., warm:], site_id[..., warm:], busy,
            None if hit is None else hit[..., warm:])


def fleet_one_raw(
    generator: torch.Generator | None,
    pi: Tensor,
    lam_cs: Tensor,
    overheads_cs: Tensor,
    rates_cs: Tensor,
    n_requests: int,
    warm: int,
    ttl: Tensor | None = None,
    hit_latency: Tensor | float = 0.0,
    *,
    draws: SimDraws | None = None,
) -> tuple:
    """One seed of the materialized fleet from raw (C, m) service
    parameters: ``(latency, file_id, site_id, busy, hit)`` after ``warm``
    requests (``hit`` None without a TTL). ``draws`` (leading (N,),
    ``site_id`` set) replace the generator's."""
    draws = _draws_for(generator, draws, lam_cs, (n_requests,), pi.shape[-1], False)
    if draws.site_id is None:
        raise ValueError("fleet draws need site_id")
    return _fleet_one(draws, pi, overheads_cs, rates_cs, warm, ttl,
                      _hit_latency(hit_latency, pi.device))


def _fleet_stream_batched(
    generator, draws, pi, lam_cs, overheads_cs, rates_cs, ttl, hit_latency,
    n_seeds, n_chunks, block, warm, sketch, materialize=False, shards=None,
):
    """Streaming fleet: a device loop over ``n_chunks`` request blocks.

    The carry — FCFS ``dep`` and accrued ``busy``, the absolute clock, the
    cache warmth (S, r), the streaming accumulators and the hit count, all
    (S,)-batched — keeps memory at O(S x block) whatever the horizon. Each
    chunk draws its block (arrivals continue from the carried clock), runs
    ONE B1 launch from the carried state, and folds the block's post-warmup
    latencies into the global accumulators and that chunk's window stats.
    ``materialize`` also keeps every block's latencies (validation).
    With ``shards`` the launch is one a device on its seeds, and each
    device's ``dep`` and ``busy`` stay on it from chunk to chunk.
    """
    dev = pi.device
    s, m = n_seeds, overheads_cs.shape[-1]
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    dep, busy, t0 = zeros(s, m), zeros(s, m), zeros(s)
    if shards is not None:
        dep, busy = shards.split(dep), shards.split(busy)
    cache = None  # cold: the pre-scan starts every file expired
    stats = stream_init(sketch, (s,), device=dev)
    hit_count = None if ttl is None else torch.zeros((s,), dtype=torch.int32, device=dev)
    windows, lats = [], []
    for w in range(n_chunks):
        chunk = _draws_for(generator, None if draws is None else draws.at(w), lam_cs,
                           (s, block), m, False)
        t, _, _, masks, service, hit, cache = _fleet_inputs(
            chunk, pi, overheads_cs, rates_cs, ttl, t0, cache)
        latency, dep, busy = _scan_split(shards, t, masks, service, dep, busy)
        if hit is not None:
            latency = torch.where(hit, hit_latency, latency)
        include = (w * block + torch.arange(block, device=dev) >= warm).expand(latency.shape)
        window = stream_from_values(latency, sketch, include=include)
        stats = stream_merge(stats, window)
        if hit is not None:
            hit_count = hit_count + torch.sum(hit & include, dim=1, dtype=torch.int32)
        t0 = t[:, -1]
        windows.append(window)
        if materialize:
            lats.append(latency)
    windows = StreamingStats(*(torch.stack(f, dim=1) for f in zip(*windows)))
    return (stats, windows, _gathered(shards, busy), hit_count,
            torch.cat(lats, dim=1) if materialize else None)


def simulate_fleet(
    generator: torch.Generator | None,
    pi: Tensor,
    lam_cs: Tensor,
    fabric: GeoFabric,
    chunk_mb: float,
    n_requests: int,
    n_seeds: int,
    *,
    drop_warmup: float = 0.1,
    devices: str = "auto",
    cache_ttl: Tensor | None = None,
    cache_hit_latency: float = 0.0,
    stream: bool = False,
    n_chunks: int = 1,
    sketch: SketchSpec | None = None,
    keep_latency: bool = False,
    draws: SimDraws | None = None,
) -> FleetResult:
    """Simulate ``n_seeds`` independent geo systems as one batched run.

    The fleet axis is pure data parallelism: every seed draws its own
    workload, Madow service sets and service times (all seeds at once, on
    ``fabric.cluster.device``), then ONE (S, m)-wide FCFS scan walks all
    seeds together.

    ``cache_ttl`` (r,) puts one hot-tier cache (cold at t = 0) in front of
    every seed's queues; hits return at ``cache_hit_latency`` and the
    materialized result carries ``hit``. ``stream=True`` switches to the
    streaming path: ``n_chunks`` blocks of ``n_requests`` each, one B1
    launch a chunk from the carried state, folded into streaming
    statistics (``FleetResult.stream``, per-chunk ``windows``, and
    ``hit_count`` with a cache) with bin geometry ``sketch`` (default
    :data:`~.streaming.DEFAULT_SKETCH`); ``keep_latency`` (validation)
    also keeps the whole latency matrix. The warmup dropped is
    ``drop_warmup`` of the whole horizon.

    ``draws`` replace the generator's, each with a leading (S, N) axis and
    ``site_id`` set; a streaming run takes a leading (W, S, N) chunk axis
    (or (S, N) for one chunk). With ``devices="auto"`` and several CUDA
    devices the seed axis is split over them (``_simulate_fleet_on``);
    ``"never"`` runs on one. Once the inputs are on the device the run is
    the guarded hot path ``storage.simulate_fleet`` (``diag.py``).
    """
    dev = fabric.cluster.device
    on = None
    if devices == "auto" and dev.type == "cuda" and torch.cuda.device_count() > 1:
        on = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return _simulate_fleet_on(
        on, generator, pi, lam_cs, fabric, chunk_mb, n_requests, n_seeds,
        drop_warmup=drop_warmup, cache_ttl=cache_ttl, cache_hit_latency=cache_hit_latency,
        stream=stream, n_chunks=n_chunks, sketch=sketch, keep_latency=keep_latency, draws=draws)


def _simulate_fleet_on(
    devices, generator, pi, lam_cs, fabric, chunk_mb, n_requests, n_seeds, *,
    drop_warmup=0.1, cache_ttl=None, cache_hit_latency=0.0, stream=False, n_chunks=1,
    sketch=None, keep_latency=False, draws=None,
) -> FleetResult:
    """:func:`simulate_fleet` with its seed axis split over ``devices`` (a
    list, or None for the inputs' device alone), as the reference's
    ``shard_map`` over a seed axis does: the axis is padded up to a
    multiple of the device count (padded seeds replay the first ones and are
    sliced away), the draws and every input are made once on the inputs'
    device, as on one device, each device runs one B1 launch on its seeds
    (a streaming run: one a chunk, each device's queue state carried on it)
    and the results are gathered back. So each seed's trajectory is bitwise
    the one-device run's. A device that fails raises."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if n_chunks > 1 and not stream:
        raise ValueError(
            "chunked horizons (n_chunks > 1) require stream=True — the "
            "materialized path would allocate the full horizon anyway"
        )
    if keep_latency and not stream:
        raise ValueError("keep_latency only applies to stream=True runs")
    dev = fabric.cluster.device
    pi = _on(pi, dev)
    lam_cs = _on(lam_cs, dev)
    if draws is not None and draws.site_id is None:
        raise ValueError("fleet draws need site_id")
    d, rates = fabric.service_params(chunk_mb)
    ttl = None if cache_ttl is None else _on(cache_ttl, dev)
    hit_latency = _hit_latency(cache_hit_latency, dev)
    if stream:
        sketch = DEFAULT_SKETCH if sketch is None else sketch
        sketch.edges_on(dev)  # the bucket edges reach the device before the guard
    # the inputs are on the device: the run itself is a guarded hot path
    with diag.hot_path("storage.simulate_fleet"):
        return _simulate_fleet_device(
            generator, pi, lam_cs, d, rates, n_requests, n_seeds, drop_warmup,
            ttl, hit_latency, stream, n_chunks, sketch, keep_latency, draws, devices)


def _simulate_fleet_device(
    generator, pi, lam_cs, d, rates, n_requests, n_seeds, drop_warmup, ttl,
    hit_latency, stream, n_chunks, sketch, keep_latency, draws, devices=None,
) -> FleetResult:
    """:func:`simulate_fleet` once its inputs are on the device."""
    shards = lambda s: None if devices is None else _Shards(devices, s, pi.device)
    if stream:
        if draws is not None and draws.arrival.dim() == 2:
            draws = SimDraws(*(None if x is None else x[None] for x in draws))
        if draws is not None and draws.arrival.shape[0] != n_chunks:
            raise ValueError(
                f"draws hold {draws.arrival.shape[0]} chunks, n_chunks is {n_chunks}")
        if draws is not None:
            n_seeds, n_requests = draws.arrival.shape[1:]
        warm = int(n_requests * n_chunks * drop_warmup)
        stats, windows, busy, hit_count, lats = _fleet_stream_batched(
            generator, draws, pi, lam_cs, d, rates, ttl, hit_latency, n_seeds,
            n_chunks, n_requests, warm, sketch, keep_latency, shards(n_seeds))
        return FleetResult(
            latency=lats, file_id=None, site_id=None, node_busy=busy, hit=None,
            stream=stats, windows=windows, hit_count=hit_count, sketch=sketch,
        )
    draws = _draws_for(generator, draws, lam_cs, (n_seeds, n_requests), d.shape[-1], False)
    warm = int(draws.arrival.shape[-1] * drop_warmup)
    return FleetResult(*_fleet_one(draws, pi, d, rates, warm, ttl, hit_latency,
                                   shards(draws.arrival.shape[0])))
