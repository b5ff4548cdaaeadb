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
the reference's own draws. Segments, degraded reads, caches, sketches and
streaming fleets are not ported yet (ROADMAP.md queue A, step 14).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from repro_torch.core.scheduling import madow_sample
from repro_torch.kernels.fcfs_queue import fcfs_scan

from .cluster import Cluster, GeoFabric


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

    def mean_latency(self) -> Tensor:
        return torch.mean(self.latency)

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
    draws: SimDraws | None = None,
) -> SimResult:
    """Simulate probabilistic scheduling for dispatch matrix ``pi`` (r, m).

    Runs on ``cluster.device``. ``per_file_chunk_mb`` (r,) gives
    heterogeneous per-file chunk sizes (the §V.B catalog). ``draws``
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
    return SimResult(
        latency=latency[warm:],
        file_id=draws.file_id[warm:],
        arrival=draws.arrival[warm:],
        node_busy=busy,
    )


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

    Not ported yet (ROADMAP.md queue A, step 14): ``stream=True``,
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
