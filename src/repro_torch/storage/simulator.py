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
host-side reporting. Segments, degraded reads, caches and streaming fleets
are not ported yet (ROADMAP.md queue A: A14, with A13 for the cache tier).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.scheduling import madow_sample
from repro_torch.kernels.fcfs_queue import fcfs_scan

from .cluster import Cluster, GeoFabric
from .streaming import SketchSpec, StreamingStats, stream_from_values


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
    """The random inputs of a run; leading axes (N,) or (S, N)."""

    arrival: Tensor  # absolute arrival times
    file_id: Tensor  # int64 file marks
    u: Tensor  # one U[0, 1) Madow uniform per request
    exp: Tensor  # (..., N, m) unit exponentials for the service draws
    site_id: Tensor | None = None  # int64 client-site marks (fleet only)


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

    Materialized fields only: the streaming sketches of the reference are
    not ported yet.
    """

    latency: Tensor  # (S, N) post-warmup latencies
    file_id: Tensor  # (S, N)
    site_id: Tensor  # (S, N)
    node_busy: Tensor  # (S, m)

    def mean_latency(self) -> Tensor:
        return torch.mean(self.latency)

    def per_site_mean(self, n_sites: int) -> Tensor:
        """(C,) mean latency by request origin site; a site that originated
        no request gets NaN, never a 0-count mean."""
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
    generator: torch.Generator, lam_cs: Tensor, shape: tuple[int, ...], m: int
) -> SimDraws:
    t, file_id, site_id = _workload(generator, lam_cs, shape)
    dev = lam_cs.device
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=dev)
    exp = torch.empty(shape + (m,), dtype=torch.float32, device=dev)
    exp.exponential_(generator=generator)
    return SimDraws(t, file_id, u, exp, site_id)


def _check_generator(generator: torch.Generator | None, device: torch.device):
    if generator is None:
        raise ValueError("pass a torch.Generator or explicit draws")
    if generator.device != device:
        raise ValueError(
            f"generator is on {generator.device}, the simulated system on {device}"
        )


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
    if draws is None:
        _check_generator(generator, dev)
        draws = _draw(generator, lam[None, :], (n_requests,), m)
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
    stream: bool = False,
    n_chunks: int = 1,
    draws: SimDraws | None = None,
) -> FleetResult:
    """Simulate ``n_seeds`` independent geo systems as one batched run.

    The fleet axis is pure data parallelism: every seed draws its own
    workload, Madow service sets and service times (all seeds at once, on
    ``fabric.cluster.device``), then ONE (S, m)-wide FCFS scan walks all
    seeds together. ``draws`` replaces the generator's draws, each with a
    leading (S, N) axis and ``site_id`` set.

    Not ported yet (ROADMAP.md queue A, A14): ``stream=True``,
    ``n_chunks > 1``, ``cache_ttl`` and sharding seeds over several
    devices; each raises ``NotImplementedError``.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    dev = fabric.cluster.device
    unported = {
        "stream=True": stream,
        "n_chunks > 1": n_chunks > 1,
        "cache_ttl": cache_ttl is not None,
        "devices='auto' over several CUDA devices": (
            devices == "auto" and dev.type == "cuda" and torch.cuda.device_count() > 1
        ),
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"simulate_fleet({what}) is not ported yet (ROADMAP.md, queue A)"
            )
    pi = _on(pi, dev)
    lam_cs = _on(lam_cs, dev)
    if draws is None:
        _check_generator(generator, dev)
        draws = _draw(generator, lam_cs, (n_seeds, n_requests), fabric.m)
    elif draws.site_id is None:
        raise ValueError("fleet draws need site_id")
    d, rates = fabric.service_params(chunk_mb)
    service = d[draws.site_id] + draws.exp / rates[draws.site_id]
    masks = madow_sample(draws.u, pi[draws.file_id])
    # busy accrues in the scan's carry, not per step: an (S, N, m) busy
    # output would dominate the kernel's memory traffic
    latency, _, busy = fcfs_scan(draws.arrival, masks, service)
    warm = int(draws.arrival.shape[-1] * drop_warmup)
    return FleetResult(
        latency=latency[:, warm:],
        file_id=draws.file_id[:, warm:],
        site_id=draws.site_id[:, warm:],
        node_busy=busy,
    )
