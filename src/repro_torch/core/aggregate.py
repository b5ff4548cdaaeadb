"""Hierarchical planning: million-file catalogs at O(100)-row solve cost.

Production catalogs hold 10^6-10^9 objects. Two composable aggregations
collapse the row count before the solve and recover a per-file plan
afterwards:

* **Clustering** (:func:`cluster_catalog`): files are grouped by their
  discrete catalog class (erasure k, size class) crossed with a log2 bin
  of the arrival rate, optionally refined by 1-D weighted Lloyd (k-means)
  on the occupied bins. The per-file work is a handful of vectorized
  numpy passes (exponent-bit extraction + ``bincount``). Cluster rows
  carry the summed arrival rate (the latency fold is linear in lam, so
  this is exact for cluster-constant plans) and a ``cost_weight`` equal to
  the file count (each member file pays storage).
* **Volumes** (:func:`volume_catalog`): SeaweedFS-style fixed-capacity
  bins by (size, rate) class. A volume is the stored unit, erasure-coded
  once, and its member files share its row, so a volume row has
  ``cost_weight = 1``.

The catalog and clustering code is host numpy in float64, the reference's
own code, so its output agrees with the reference bit for bit. The solve
runs where the problem's tensors live. Disaggregation is an exact gather
(:func:`materialize`): every file receives its cluster's pi row, bit for
bit, on the plan's device. :func:`duality_gap` bounds what the cluster
restriction leaves on the table (Frank-Wolfe).

:func:`resolve_incremental` re-solves only the clusters whose rates moved
beyond a threshold: frozen rows keep their pi and enter the subproblem as
``background`` node load, moved rows warm-start from the previous plan,
and the subproblem pads to a power-of-two row count with zero-rate,
zero-cost dummy rows (which also decide where its stop test lands, so the
padding is kept as the reference has it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .jlcm import (
    JLCMProblem,
    JLCMSolution,
    _as_problem,
    _finalize,
    _merged_grad,
    _refresh_z,
    _scalar,
    smoothed_objective,
    solve,
)
from .queueing import ServiceMoments, node_arrival_rates

# Rate-bin key layout: key = class_id << RATE_BITS | rate_bin. float64
# exponents span 11 bits; with up to 2 sub-octave bits that is <= 13, and
# 14 keeps the shifted-out sign bit of view(int64) >> shift harmless for
# positive rates.
RATE_BITS = 14


class Catalog(NamedTuple):
    """A file population as host-side numpy arrays (vectorized, no loops).

    ``class_id`` is discrete catalog metadata — the (erasure-k, size)
    class every real system records at ingest; ``class_key`` is the same
    id pre-shifted by ``RATE_BITS`` so the timed clustering path never
    pays an extra O(r) multiply.
    """

    lam: np.ndarray  # (r,) float64 arrival rates
    k: np.ndarray  # (r,) int32 erasure k per file
    chunk_mb: np.ndarray  # (r,) float64 chunk size each read fetches
    class_id: np.ndarray  # (r,) int32 discrete (k, size) class
    class_key: np.ndarray  # (r,) int64 == class_id << RATE_BITS
    k_of_class: np.ndarray  # (n_classes,) int32
    chunk_of_class: np.ndarray  # (n_classes,) float64
    file_mb_of_class: np.ndarray  # (n_classes,) float64 whole-file size

    @property
    def r(self) -> int:
        return self.lam.shape[0]

    @property
    def n_classes(self) -> int:
        return self.k_of_class.shape[0]


def synthetic_catalog(
    r: int,
    *,
    total_rate: float = 0.125,
    k_classes: tuple[int, ...] = (4, 5, 6, 7),
    file_mb: tuple[float, ...] = (75.0, 300.0),
    rate_sigma: float = 1.0,
    seed: int = 0,
) -> Catalog:
    """A heterogeneous r-file catalog, fully vectorized (no per-file loops).

    Files draw a (k, size) class uniformly and a lognormal arrival rate,
    normalized so the catalog's total request rate is ``total_rate``
    regardless of r — the "same traffic, more objects" scaling that makes
    catalog sizes comparable against one fleet. At r = 1000 the totals
    match the paper's r=1000 testbed regime.
    """
    rng = np.random.default_rng(seed)
    kc = rng.integers(0, len(k_classes), r).astype(np.int32)
    sc = rng.integers(0, len(file_mb), r).astype(np.int32)
    class_id = (kc * len(file_mb) + sc).astype(np.int32)
    k_of_class = np.repeat(np.asarray(k_classes, np.int32), len(file_mb))
    file_mb_of_class = np.tile(np.asarray(file_mb, np.float64), len(k_classes))
    chunk_of_class = file_mb_of_class / k_of_class
    lam = rng.lognormal(mean=-9.0, sigma=rate_sigma, size=r)
    lam *= total_rate / lam.sum()
    return Catalog(
        lam=lam,
        k=k_of_class[class_id],
        chunk_mb=chunk_of_class[class_id],
        class_id=class_id,
        class_key=(class_id.astype(np.int64) << RATE_BITS),
        k_of_class=k_of_class,
        chunk_of_class=chunk_of_class,
        file_mb_of_class=file_mb_of_class,
    )


class Hierarchy(NamedTuple):
    """Cluster-level catalog plus the exact file -> cluster map."""

    key: np.ndarray  # (r,) int64 per-file aggregation key
    cluster_of_key: np.ndarray  # (keyspace,) int32, -1 where empty
    lam: np.ndarray  # (C,) float64 summed arrival rate per cluster
    counts: np.ndarray  # (C,) int64 member files per cluster
    k: np.ndarray  # (C,) int32
    chunk_mb: np.ndarray  # (C,) float64 traffic-weighted member chunk
    cost_weight: np.ndarray  # (C,) float64 storage multiplicity per row
    class_id: np.ndarray  # (C,) int32

    @property
    def n_clusters(self) -> int:
        return self.lam.shape[0]

    def cluster_of_file(self) -> np.ndarray:
        """(r,) int32 cluster index per file (one gather)."""
        return self.cluster_of_key[self.key]


def kmeans1d(
    values: np.ndarray,
    weights: np.ndarray,
    n_clusters: int,
    *,
    iters: int = 25,
) -> np.ndarray:
    """Weighted 1-D k-means (Lloyd) -> cluster index per value.

    Sorted 1-D Lloyd: assignment by nearest-centroid boundary via
    ``searchsorted``, update by ``bincount`` means. Meant for the occupied
    *bins* of a clustered catalog (hundreds of points), where it is
    microseconds; it is O(n log n) and safe for direct use on raw values
    too.
    """
    values = np.asarray(values, np.float64)
    weights = np.asarray(weights, np.float64)
    n_clusters = min(n_clusters, np.unique(values).size)
    order = np.argsort(values)
    v, w = values[order], weights[order]
    # quantile-spread init over the weighted mass
    cw = np.cumsum(w)
    targets = (np.arange(n_clusters) + 0.5) / n_clusters * cw[-1]
    centers = v[np.searchsorted(cw, targets)]
    centers = np.unique(centers)
    for _ in range(iters):
        bounds = 0.5 * (centers[1:] + centers[:-1])
        assign = np.searchsorted(bounds, v)
        mass = np.bincount(assign, weights=w, minlength=centers.size)
        wsum = np.bincount(assign, weights=w * v, minlength=centers.size)
        keep = mass > 0
        new_centers = wsum[keep] / mass[keep]
        if new_centers.size == centers.size and np.allclose(
            new_centers, centers
        ):
            centers = new_centers
            break
        centers = new_centers
    bounds = 0.5 * (centers[1:] + centers[:-1])
    return np.searchsorted(bounds, values).astype(np.int32)


def cluster_catalog(
    catalog: Catalog,
    *,
    bins_per_octave: int = 1,
    n_rate_clusters: int | None = None,
    lloyd_iters: int = 25,
) -> Hierarchy:
    """Group files into O(100) clusters by (class, log2-rate bin).

    The per-file work is exactly four vectorized passes — exponent-bit
    extraction from the float64 rate (``view(int64) >> shift`` is a free
    log2 floor), one in-place add of the precomputed class key, and two
    ``bincount`` reductions (counts and exact lam sums) — everything else
    operates on the <= ``n_classes << RATE_BITS`` key table. Rate mass is
    conserved exactly (bincount sums every file's lam once).

    ``bins_per_octave`` in {1, 2, 4} controls rate resolution.
    ``n_rate_clusters`` additionally refines each class's occupied bins
    with weighted 1-D k-means (:func:`kmeans1d`) on log2(rate) down to at
    most that many rate clusters per class — coarser than the raw bins
    when fewer clusters are requested, at zero extra per-file cost (the
    file -> cluster map composes through the key table).
    """
    if bins_per_octave not in (1, 2, 4):
        raise ValueError("bins_per_octave must be 1, 2, or 4")
    sub = int(bins_per_octave).bit_length() - 1
    shift = 52 - sub
    if np.any(catalog.lam <= 0.0):
        raise ValueError("clustering needs strictly positive arrival rates")

    # the entire O(r) work: one shift (log2 floor via exponent bits), one
    # in-place add of the precomputed class key, two bincount reductions
    key = catalog.lam.view(np.int64) >> shift
    np.add(key, catalog.class_key, out=key)
    keyspace = catalog.n_classes << RATE_BITS
    counts = np.bincount(key, minlength=keyspace)
    sums = np.bincount(key, weights=catalog.lam, minlength=keyspace)

    occupied = np.flatnonzero(counts)
    cluster_of_key = np.full(keyspace, -1, np.int32)
    bin_class = (occupied >> RATE_BITS).astype(np.int32)
    if n_rate_clusters is not None:
        # refine on the occupied-bin table: per class, Lloyd on the
        # traffic-weighted log-rates of its bins
        log_rate = np.log2(sums[occupied] / counts[occupied])
        cid = np.zeros(occupied.size, np.int32)
        next_id = 0
        for c in range(catalog.n_classes):
            in_c = np.flatnonzero(bin_class == c)
            if in_c.size == 0:
                continue
            sub_assign = kmeans1d(
                log_rate[in_c],
                sums[occupied][in_c],
                n_rate_clusters,
                iters=lloyd_iters,
            )
            cid[in_c] = next_id + sub_assign
            next_id += int(sub_assign.max()) + 1
        n_clusters = next_id
    else:
        cid = np.arange(occupied.size, dtype=np.int32)
        n_clusters = occupied.size
    cluster_of_key[occupied] = cid

    lam_c = np.bincount(cid, weights=sums[occupied], minlength=n_clusters)
    counts_c = np.bincount(
        cid, weights=counts[occupied].astype(np.float64), minlength=n_clusters
    ).astype(np.int64)
    class_c = np.zeros(n_clusters, np.int32)
    class_c[cid] = bin_class  # class is constant within a cluster
    chunk_c = catalog.chunk_of_class[class_c]
    return Hierarchy(
        key=key,
        cluster_of_key=cluster_of_key,
        lam=lam_c,
        counts=counts_c,
        k=catalog.k_of_class[class_c],
        chunk_mb=chunk_c,
        cost_weight=counts_c.astype(np.float64),
        class_id=class_c,
    )


def volume_catalog(catalog: Catalog, volume_mb: float = 1024.0) -> Hierarchy:
    """Pack files into ~``volume_mb`` volumes per (k, size) class.

    A volume is the stored, erasure-coded unit (SeaweedFS): member files
    share its placement and dispatch row, and the row's storage weight is
    1 — the volume's chunks exist once no matter how many files pack into
    it. Reads remain file-sized (``chunk_mb`` is the member chunk), the
    needle-read model. Assignment is deterministic: files fill volumes in
    catalog order within their class.
    """
    order = np.argsort(catalog.class_id, kind="stable")
    fmb = catalog.file_mb_of_class[catalog.class_id]
    sorted_sizes = fmb[order]
    run = np.cumsum(sorted_sizes)
    cls_sorted = catalog.class_id[order]
    starts = np.flatnonzero(np.diff(cls_sorted, prepend=-1))
    base = np.zeros(catalog.r)
    base[starts] = np.concatenate(([0.0], run[starts[1:] - 1]))
    run = run - np.maximum.accumulate(base)
    vol_in_class = ((run - 1e-9) // volume_mb).astype(np.int64)
    # unique volume key = class << vbits | within-class volume index; the
    # shift grows with the catalog so volumes never silently merge
    vbits = max(RATE_BITS, int(vol_in_class.max()).bit_length() + 1)
    key_sorted = (cls_sorted.astype(np.int64) << vbits) + vol_in_class
    key = np.empty(catalog.r, np.int64)
    key[order] = key_sorted
    keyspace = catalog.n_classes << vbits
    counts = np.bincount(key, minlength=keyspace)
    sums = np.bincount(key, weights=catalog.lam, minlength=keyspace)
    occupied = np.flatnonzero(counts)
    cluster_of_key = np.full(keyspace, -1, np.int32)
    cluster_of_key[occupied] = np.arange(occupied.size, dtype=np.int32)
    class_c = (occupied >> vbits).astype(np.int32)
    counts_c = counts[occupied]
    return Hierarchy(
        key=key,
        cluster_of_key=cluster_of_key,
        lam=sums[occupied],
        counts=counts_c,
        k=catalog.k_of_class[class_c],
        chunk_mb=catalog.chunk_of_class[class_c],
        cost_weight=np.ones(occupied.size),
        class_id=class_c,
    )


def effective_chunk_mb(h: Hierarchy) -> float:
    """Traffic-weighted mean chunk size over clusters (tiny table op)."""
    return float(np.average(h.chunk_mb, weights=h.lam))


def build_problem(
    h: Hierarchy,
    moments: ServiceMoments,
    cost: Tensor,
    theta: float,
    *,
    unit_cost_weight: bool | None = None,
) -> JLCMProblem:
    """The cluster-granularity :class:`JLCMProblem` for a hierarchy, on
    ``cost``'s device.

    ``cost_weight`` comes from the hierarchy (file counts for clusters,
    ones for volumes); an all-ones weight is passed as ``None`` so volume
    problems stay bit for bit on the dense solver path.
    """
    w = h.cost_weight
    if unit_cost_weight is None:
        unit_cost_weight = bool(np.all(w == 1.0))
    device = torch.as_tensor(cost).device
    return JLCMProblem(
        lam=torch.as_tensor(h.lam, dtype=torch.float32, device=device),
        k=torch.as_tensor(h.k, dtype=torch.int32, device=device),
        moments=moments,
        cost=cost,
        theta=theta,
        cost_weight=None if unit_cost_weight else torch.as_tensor(
            w, dtype=torch.float32, device=device
        ),
    )


class FactoredPlan(NamedTuple):
    """A million-file plan in O(C m) space: cluster rows + the exact map.

    Per-file rows are one gather (:func:`materialize`), made only when a
    consumer needs the dense (r, m) tensor.
    """

    hierarchy: Hierarchy
    cluster_pi: Tensor  # (C, m)
    cluster_lam: np.ndarray  # (C,) rates the plan was solved at


def materialize(plan: FactoredPlan) -> Tensor:
    """Exact disaggregation on the plan's device: every file gets its
    cluster's row, bit for bit (a gather does no arithmetic)."""
    cid = torch.as_tensor(
        plan.hierarchy.cluster_of_file(), dtype=torch.int64,
        device=plan.cluster_pi.device,
    )
    return plan.cluster_pi[cid]


def solve_hierarchical(
    h: Hierarchy,
    moments: ServiceMoments,
    cost: Tensor,
    theta: float,
    **solve_kw,
) -> tuple[FactoredPlan, JLCMSolution]:
    """Aggregate -> solve at cluster granularity -> factored plan."""
    sol = solve(build_problem(h, moments, cost, theta), **solve_kw)
    return FactoredPlan(h, sol.pi, h.lam.copy()), sol


@torch.no_grad()
def evaluate_pi(prob: JLCMProblem, pi: Tensor) -> JLCMSolution:
    """Objective, latency and cost of a fixed plan on ``prob`` (no
    iterations): how a disaggregated plan scores on the file-level problem
    it never solved."""
    prob = _as_problem(prob._replace(mask=None))
    pi = torch.as_tensor(pi, dtype=torch.float32, device=prob.lam.device)
    z = _refresh_z(pi, prob)
    obj = smoothed_objective(pi, z, prob, _scalar(1e3, pi.device))
    return _finalize(pi, z, prob, obj[None])


def duality_gap(prob: JLCMProblem, pi: Tensor, *, beta: float = 1e3) -> float:
    """Frank-Wolfe duality gap of the convex inner subproblem at ``pi``.

    For the z-refreshed, cost-linearized subproblem f, convexity gives
    ``f(pi) - min f <= <grad f(pi), pi - y*>`` with ``y*`` the linear
    minimum over the capped-simplex polytope, which puts 1 on each row's
    k_i smallest gradient entries. A certificate at any granularity: at a
    disaggregated plan on the file-level problem it bounds how much
    objective the cluster restriction left on the table.
    """
    prob = _as_problem(prob._replace(mask=None))
    pi = torch.as_tensor(pi, dtype=torch.float32, device=prob.lam.device)
    with torch.no_grad():
        z = _refresh_z(pi, prob)
    g = _merged_grad(pi, z, prob, _scalar(beta, pi.device))
    k = prob.k.to(torch.int64)
    prefix = torch.cumsum(torch.sort(g, dim=-1).values, dim=-1)
    lin_min = torch.take_along_dim(prefix, (k - 1)[..., None], dim=-1)[..., 0]
    gap = torch.sum(g * pi, dim=(-2, -1)) - torch.sum(lin_min, dim=-1)
    return float(gap)


class IncrementalInfo(NamedTuple):
    n_resolved: int  # clusters re-solved this call
    n_clusters: int
    iterations: int  # solver iterations of the subproblem (0 if skipped)
    padded_rows: int  # subproblem row count after power-of-2 padding


def _pad_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def resolve_incremental(
    plan: FactoredPlan,
    new_lam: np.ndarray,
    moments: ServiceMoments,
    cost: Tensor,
    theta: float,
    *,
    threshold: float = 0.2,
    **solve_kw,
) -> tuple[FactoredPlan, IncrementalInfo]:
    """Re-solve only the clusters whose rates moved; freeze the rest.

    A cluster is moved when its estimated rate changed by more than
    ``threshold`` relatively against the rates the plan was solved at.
    Frozen clusters keep their pi rows and enter the subproblem as
    ``background`` node arrival rates at the NEW rates (their traffic still
    fills the queues). Moved rows warm-start from the previous plan. The
    subproblem pads with zero-rate, zero-cost dummy rows (k = 1) to the
    next power of two.
    """
    h = plan.hierarchy
    new_lam = np.asarray(new_lam, np.float64)
    if new_lam.shape != plan.cluster_lam.shape:
        raise ValueError(
            f"new_lam shape {new_lam.shape} != cluster count "
            f"{plan.cluster_lam.shape}"
        )
    rel = np.abs(new_lam - plan.cluster_lam) / np.maximum(plan.cluster_lam, 1e-300)
    moved = rel > threshold
    n_moved = int(moved.sum())
    C = h.n_clusters
    if n_moved == 0:
        return (
            FactoredPlan(h, plan.cluster_pi, plan.cluster_lam),
            IncrementalInfo(0, C, 0, 0),
        )

    moved_idx = np.flatnonzero(moved)
    frozen_idx = np.flatnonzero(~moved)
    device = plan.cluster_pi.device
    pi_np = plan.cluster_pi.detach().cpu().numpy()
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    background = node_arrival_rates(f32(pi_np[frozen_idx]), f32(new_lam[frozen_idx]))

    rows = _pad_pow2(n_moved)
    lam_sub = np.zeros(rows)
    lam_sub[:n_moved] = new_lam[moved_idx]
    k_sub = np.ones(rows, np.int32)
    k_sub[:n_moved] = h.k[moved_idx]
    w_sub = np.zeros(rows)
    w_sub[:n_moved] = h.cost_weight[moved_idx]
    pi0 = np.zeros((rows, pi_np.shape[1]), np.float32)
    pi0[:n_moved] = pi_np[moved_idx]
    pi0[n_moved:, 0] = 1.0  # dummy rows: any feasible point for k=1

    sub = JLCMProblem(
        lam=f32(lam_sub),
        k=torch.as_tensor(k_sub, device=device),
        moments=moments,
        cost=cost,
        theta=theta,
        cost_weight=f32(w_sub),
        background=background,
    )
    sol = solve(sub, pi0=f32(pi0), **solve_kw)

    pi_new = pi_np.copy()
    pi_new[moved_idx] = sol.pi[:n_moved].cpu().numpy()
    lam_new = plan.cluster_lam.copy()
    lam_new[moved_idx] = new_lam[moved_idx]
    return (
        FactoredPlan(h, f32(pi_new), lam_new),
        IncrementalInfo(n_moved, C, int(sol.iterations), rows),
    )
