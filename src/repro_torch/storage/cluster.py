"""Storage cluster model: the paper's testbed as a calibrated substrate.

The prototype (§V.A, Fig. 5) runs 12 Tahoe storage VMs across three
OpenStack DCs (New Jersey / Texas / California) with the client in NJ.
Node j serving a chunk of size B is modelled as

    X_j  =  D_j + Exp(bw_j / B)        (shifted exponential)

with D_j the deterministic overhead and bw_j the effective client<->site
bandwidth. A :class:`Cluster` holds its tensors on one device, ``cuda``
unless the caller asks for another; asking for ``cuda`` where no card is
present raises.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.queueing import ServiceMoments, shifted_exponential_moments


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is present; "
                "pass device='cpu' to run on the host"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class StorageNode:
    name: str
    site: str
    overhead_s: float  # deterministic per-chunk service floor D_j
    bandwidth_mbps: float  # effective MB/s for chunk transfer
    cost_per_chunk: float  # V_j, dollars per stored chunk


@dataclasses.dataclass(frozen=True)
class Cluster:
    nodes: tuple[StorageNode, ...]
    device: torch.device | str = "cuda"

    def __post_init__(self) -> None:
        object.__setattr__(self, "device", _device(self.device))

    @property
    def m(self) -> int:
        return len(self.nodes)

    def _tensor(self, values) -> Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)

    @property
    def cost(self) -> Tensor:
        return self._tensor([nd.cost_per_chunk for nd in self.nodes])

    def overheads(self) -> Tensor:
        return self._tensor([nd.overhead_s for nd in self.nodes])

    def bandwidths(self) -> Tensor:
        return self._tensor([nd.bandwidth_mbps for nd in self.nodes])

    def service_params(self, chunk_mb: float | Tensor) -> tuple[Tensor, Tensor]:
        """The shifted-exponential parameterization ``(D_j, bw_j/B)``.

        ``chunk_mb`` may be a scalar or any shape broadcastable against the
        trailing node axis (e.g. ``(n, 1)`` for per-request chunk sizes).
        """
        chunk = torch.as_tensor(chunk_mb, dtype=torch.float32, device=self.device)
        return self.overheads(), self.bandwidths() / chunk

    def moments(self, chunk_mb: float) -> ServiceMoments:
        """Per-node service moments for a given chunk size (MB)."""
        d, rate = self.service_params(chunk_mb)
        return shifted_exponential_moments(d, rate)

    def sample_service(
        self, generator: torch.Generator, chunk_mb: float, shape: tuple[int, ...]
    ) -> Tensor:
        """Sample service times, shape (..., m): shifted exponential."""
        d, rate = self.service_params(chunk_mb)
        e = torch.empty(shape + (self.m,), dtype=torch.float32, device=self.device)
        return d + e.exponential_(generator=generator) / rate

    def sample_service_per_request(
        self, generator: torch.Generator, chunk_mb: Tensor, n: int
    ) -> Tensor:
        """Per-request service samples (n, m) where request i transfers
        ``chunk_mb[i]`` MB (heterogeneous per-file chunk sizes, §V.B)."""
        d, rate = self.service_params(chunk_mb[:, None])
        e = torch.empty((n, self.m), dtype=torch.float32, device=self.device)
        return d + e.exponential_(generator=generator) / rate

    def subset(self, keep: Sequence[int]) -> "Cluster":
        """Surviving-node cluster after failures (elastic replanning)."""
        return Cluster(tuple(self.nodes[i] for i in keep), device=self.device)

    def perturbed(
        self,
        overhead_scale: float | Sequence[float] = 1.0,
        bandwidth_scale: float | Sequence[float] = 1.0,
    ) -> "Cluster":
        """Cluster with drifted service parameters (same node identities).

        Scales each node's overhead D_j and/or bandwidth bw_j (scalar =
        every node, sequence = per node), so the sampled service
        distribution and :meth:`moments` drift together.
        """
        ovh = np.broadcast_to(np.asarray(overhead_scale, float), (self.m,))
        bwd = np.broadcast_to(np.asarray(bandwidth_scale, float), (self.m,))
        nodes = tuple(
            dataclasses.replace(
                nd,
                overhead_s=nd.overhead_s * float(o),
                bandwidth_mbps=nd.bandwidth_mbps * float(b),
            )
            for nd, o, b in zip(self.nodes, ovh, bwd)
        )
        return Cluster(nodes, device=self.device)


def tahoe_testbed(
    *,
    cost_nj: float = 1.0,
    cost_tx: float = 0.7,
    cost_ca: float = 0.85,
    device: str | torch.device = "cuda",
) -> Cluster:
    """12 nodes, 4 per site; client co-located with NJ (paper Fig. 5).

    The constants are the reference's calibration: the §V.B workload
    (r=1000 files, 50-200 MB, aggregate ~0.118 req/s) is feasible but
    heavily loaded. CA has higher bandwidth than TX despite larger RTT.
    """
    sites = {
        # site: (overhead_s, bandwidth_mbps) for the 4 nodes
        "NJ": [(2.2, 6.5), (2.5, 6.0), (2.8, 5.5), (3.2, 5.0)],
        "TX": [(7.5, 2.0), (8.0, 1.8), (8.5, 1.7), (9.0, 1.5)],
        "CA": [(3.2, 4.8), (3.5, 4.5), (3.8, 4.2), (4.2, 3.8)],
    }
    cost = {"NJ": cost_nj, "TX": cost_tx, "CA": cost_ca}
    nodes = tuple(
        StorageNode(
            name=f"{site.lower()}{i}",
            site=site,
            overhead_s=d,
            bandwidth_mbps=bw,
            cost_per_chunk=cost[site],
        )
        for site, specs in sites.items()
        for i, (d, bw) in enumerate(specs)
    )
    return Cluster(nodes, device=device)


def homogeneous_cluster(
    m: int,
    overhead_s: float = 9.6,
    bandwidth_mbps: float | None = None,
    chunk_mb: float = 12.5,
    sigma_s: float = 4.3,
    cost: float = 1.0,
    *,
    device: str | torch.device = "cuda",
) -> Cluster:
    """All-identical cluster matching the paper's measured Fig.-6 moments:
    sigma = chunk/bw gives bw = chunk/sigma; mean = overhead + sigma = 13.9."""
    bw = bandwidth_mbps if bandwidth_mbps is not None else chunk_mb / sigma_s
    nodes = tuple(
        StorageNode(name=f"n{i}", site="X", overhead_s=overhead_s,
                    bandwidth_mbps=bw, cost_per_chunk=cost)
        for i in range(m)
    )
    return Cluster(nodes, device=device)


def measured_fig6_moments(*, device: str | torch.device = "cuda") -> ServiceMoments:
    """The paper's measured chunk service moments (single node view)."""
    f32 = lambda x: torch.tensor([x], dtype=torch.float32, device=_device(device))
    return ServiceMoments(mu=f32(1.0 / 13.9), m2=f32(211.8), m3=f32(3476.8))


# ---------------------------------------------------------------------------
# Geo-aware client fabric: per-(client-site, node) network profiles.
# C = 1 is the paper's own single-client model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClientSite:
    """One client population site and its network profile to each DC,
    relative to the cluster's calibrated NJ client: an additive RTT delta
    and a bandwidth scale per storage site."""

    name: str
    rtt_s: dict[str, float]
    bandwidth_scale: dict[str, float]

    @classmethod
    def reference(cls, name: str, storage_sites: Sequence[str]) -> "ClientSite":
        """The zero-delta profile (the cluster's own calibration view)."""
        return cls(
            name=name,
            rtt_s={s: 0.0 for s in storage_sites},
            bandwidth_scale={s: 1.0 for s in storage_sites},
        )


@dataclasses.dataclass(frozen=True)
class GeoFabric:
    """A cluster plus the client sites reading from it, exposing (C, m)
    service parameters: row c is what client site c sees of every node."""

    cluster: Cluster
    sites: tuple[ClientSite, ...]

    def __post_init__(self) -> None:
        storage_sites = {nd.site for nd in self.cluster.nodes}
        for cs in self.sites:
            missing = (storage_sites - set(cs.rtt_s)) | (
                storage_sites - set(cs.bandwidth_scale)
            )
            if missing:
                raise ValueError(
                    f"client site {cs.name!r} lacks a profile for storage "
                    f"site(s) {sorted(missing)}"
                )
            bad = [s for s, v in cs.bandwidth_scale.items() if not v > 0]
            if bad:
                raise ValueError(
                    f"client site {cs.name!r} has non-positive "
                    f"bandwidth_scale for {sorted(bad)}"
                )
        if (self.overheads() <= 0).any():
            raise ValueError("an rtt_s delta drove a pair overhead <= 0")

    @property
    def n_sites(self) -> int:
        return len(self.sites)

    @property
    def m(self) -> int:
        return self.cluster.m

    @property
    def site_names(self) -> tuple[str, ...]:
        return tuple(cs.name for cs in self.sites)

    def _site_table(self, field: str) -> Tensor:
        """(C, m): each client site's per-storage-site ``field`` per node."""
        return self.cluster._tensor([
            [getattr(cs, field)[nd.site] for nd in self.cluster.nodes]
            for cs in self.sites
        ])

    def overheads(self) -> Tensor:
        """(C, m) deterministic floors D_j + RTT_{c, site_j}."""
        return self.cluster.overheads() + self._site_table("rtt_s")

    def bandwidths(self) -> Tensor:
        """(C, m) effective bandwidths bw_j * scale_{c, site_j}."""
        return self.cluster.bandwidths() * self._site_table("bandwidth_scale")

    def service_params(self, chunk_mb: float | Tensor) -> tuple[Tensor, Tensor]:
        """(C, m) shifted-exponential params, the geo twin of
        :meth:`Cluster.service_params`."""
        chunk = torch.as_tensor(
            chunk_mb, dtype=torch.float32, device=self.cluster.device
        )
        return self.overheads(), self.bandwidths() / chunk

    def moments(self, chunk_mb: float) -> ServiceMoments:
        """Per-(client site, node) service moments, tensors shaped (C, m)."""
        d, rate = self.service_params(chunk_mb)
        return shifted_exponential_moments(d, rate)

    def uniform_mix(self, r: int) -> np.ndarray:
        """(r, C) client mix with every file read uniformly from all sites."""
        return np.full((r, self.n_sites), 1.0 / self.n_sites)

    def site_index(self, name: str) -> int:
        return self.site_names.index(name)

    @classmethod
    def single_site(cls, cluster: Cluster, name: str = "ref") -> "GeoFabric":
        """The one-client-site fabric: the cluster's own model, exactly."""
        sites = sorted({nd.site for nd in cluster.nodes})
        return cls(cluster=cluster, sites=(ClientSite.reference(name, sites),))


def geo_testbed(cluster: Cluster | None = None) -> GeoFabric:
    """Four client sites on the 3-DC testbed (paper Fig. 5, plus a remote).

    * ``NJ``: the reference profile, the paper's own client placement
      (bitwise the base calibration).
    * ``TX`` / ``CA``: clients co-located with the other two DCs; the
      baked-in NJ-to-site RTT comes back out of the local site's overhead
      and local bandwidth scales up, while the path back to NJ pays the WAN
      RTT. CA keeps the paper's inversion (higher RTT, more bandwidth than
      TX) from every vantage point.
    * ``EU``: a remote client far from all three DCs.

    The deltas are the reference's calibration (the paper publishes no
    per-pair RTT matrix). ``cluster`` defaults to :func:`tahoe_testbed` on
    the card.
    """
    cluster = tahoe_testbed() if cluster is None else cluster
    sites = (
        ClientSite.reference("NJ", ("NJ", "TX", "CA")),
        ClientSite(
            name="TX",
            rtt_s={"NJ": 4.5, "TX": -5.5, "CA": 0.4},
            bandwidth_scale={"NJ": 0.55, "TX": 2.6, "CA": 0.9},
        ),
        ClientSite(
            name="CA",
            rtt_s={"NJ": 1.4, "TX": 0.6, "CA": -1.8},
            bandwidth_scale={"NJ": 0.75, "TX": 1.05, "CA": 1.7},
        ),
        ClientSite(
            name="EU",
            rtt_s={"NJ": 2.2, "TX": 3.5, "CA": 3.0},
            bandwidth_scale={"NJ": 0.7, "TX": 0.75, "CA": 0.7},
        ),
    )
    return GeoFabric(cluster=cluster, sites=sites)
