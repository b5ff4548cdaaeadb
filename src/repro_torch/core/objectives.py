"""Pluggable objective layer: convex compositions of per-class objectives.

The paper optimizes one scalar: the request-weighted mean latency bound
(Lemma 2 / Eq. 5) plus theta x storage cost. The same probabilistic-
scheduling machinery supports differentiated per-tenant latency (weighted
per-class means, arXiv:1602.05551) and tail-latency objectives (P[T > d],
arXiv:1703.08337). An :class:`ObjectiveSpec` travels inside
:class:`~.jlcm.JLCMProblem`, so ``solve``, ``solve_batch`` /
``stack_problems`` and the simulator's per-class reporting consume the
same spec. The composed latency objective is

    F(pi, z) =  sum_i (w_{c_i} lam_i / W) T_i-bound(z)          (weighted mean)
             +  sum_c  tw_c * P-bound[T_c > d_c]                (tail terms)

with ``W = sum_i w_{c_i} lam_i`` and the per-class tail the request-rate-
weighted average of per-file tail bounds.

Exactness contract: ``spec=None`` (or uniform weights and no deadlines),
``geo=None``, ``cache=None`` and ``background=None`` each add no op, so
the plain problem's values come out bit for bit; absent deadlines skip the
tail computation entirely.

Cache tier (hot/warm): a :class:`CacheSpec` carries per-file hot-cache
hit rates ``h_i``. Misses are what the erasure-coded warm tier serves, so
every queueing quantity is evaluated at the thinned arrivals
``lam_i (1 - h_i)`` and the mean objective becomes the hit/miss blend

    F_cache = (W_miss / W) * F_warm(lam_eff)  +  (sum_i w_i lam_i h_i / W) * t_hit

with ``W_miss = sum_i w_i lam_i (1 - h_i)``; the replicated hot tier's
storage cost joins as the constant ``hot_cost``. An all-zero hit vector
reproduces the cache-free values through exact IEEE identities
(``x * 1.0``, ``x / x == 1.0``, ``+ 0.0``).

Every function is batch-safe over leading axes (a stacked batch of
problems): per-class sums and the tail terms' bracket stay per instance.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from .geo import GeoSpec, geo_eq_varq, geo_optimal_shared_z, geo_shared_z_latency
from .latency_bound import optimal_shared_z, shared_z_latency, tail_probability_bounds
from .queueing import ServiceMoments, node_arrival_rates, pk_sojourn_moments


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, Tensor) else x)


def _per_file(values: Tensor, class_id: Tensor) -> Tensor:
    """``values[..., class_id]`` per instance: (..., C) by (..., r) -> (..., r)."""
    lead = torch.broadcast_shapes(values.shape[:-1], class_id.shape[:-1])
    return torch.gather(
        values.expand(lead + values.shape[-1:]), -1,
        class_id.expand(lead + class_id.shape[-1:]),
    )


class ObjectiveSpec(NamedTuple):
    """Declarative multi-tenant objective: who counts how much, and how.

    ``class_id``    (r,) int64: tenant/service class of each file.
    ``weight``      (C,) or None: per-class weights of the weighted mean;
                    ``None`` is the paper's uniform objective, bit for bit.
    ``deadline``    (C,) or None: per-class tail deadlines d_c. ``None``
                    disables the tail terms (no compute); ``inf`` entries
                    disable single classes.
    ``tail_weight`` (C,) or None: weight tw_c on each class's
                    P[T_c > d_c] bound; present iff ``deadline`` is.

    Problems stacked into one batch must share the structure (same C, same
    None-ness of the optional fields).
    """

    class_id: Tensor
    weight: Tensor | None = None
    deadline: Tensor | None = None
    tail_weight: Tensor | None = None

    @property
    def r(self) -> int:
        return self.class_id.shape[-1]

    @property
    def n_classes(self) -> int:
        for field in (self.weight, self.deadline, self.tail_weight):
            if field is not None:
                return field.shape[-1]
        return int(_host(self.class_id).max()) + 1

    def file_weights(self) -> Tensor | None:
        """Per-file weights w_{c_i}, shape (r,); None when uniform."""
        if self.weight is None:
            return None
        return _per_file(self.weight, self.class_id)

    def file_deadlines(self) -> Tensor | None:
        """Per-file deadlines d_{c_i}, shape (r,); None when no tail terms."""
        if self.deadline is None:
            return None
        return _per_file(self.deadline, self.class_id)

    def validate(self) -> None:
        """Raise ``ValueError`` on a malformed spec (host-side checks)."""
        if (self.deadline is None) != (self.tail_weight is None):
            raise ValueError(
                "deadline and tail_weight must be both present or both None"
            )
        cid = _host(self.class_id)
        if cid.ndim != 1:
            raise ValueError(f"class_id must be (r,), got {cid.shape}")
        c = self.n_classes
        if cid.min() < 0 or cid.max() >= c:
            raise ValueError(
                f"class ids must lie in [0, {c}), got [{cid.min()}, {cid.max()}]"
            )
        for field, label in ((self.weight, "weight"),
                             (self.deadline, "deadline"),
                             (self.tail_weight, "tail_weight")):
            if field is not None and field.shape[-1] != c:
                raise ValueError(
                    f"{label} has {field.shape[-1]} classes, expected {c}"
                )
        if self.weight is not None and (_host(self.weight) <= 0).any():
            raise ValueError("class weights must be positive")
        if self.deadline is not None and (_host(self.deadline) <= 0).any():
            raise ValueError("deadlines must be positive (use inf to disable)")
        if self.tail_weight is not None and (_host(self.tail_weight) < 0).any():
            raise ValueError("tail weights must be >= 0 (0 disables the term)")


def make_objective(
    class_id: Sequence[int] | Tensor,
    weight: Sequence[float] | None = None,
    deadline: Sequence[float] | None = None,
    tail_weight: Sequence[float] | None = None,
    *,
    device: str | torch.device = "cuda",
) -> ObjectiveSpec:
    """Build a validated :class:`ObjectiveSpec` on ``device``.

    ``deadline`` entries may be ``inf`` (or ``None``) to disable single
    classes; ``deadline`` without ``tail_weight`` weighs every finite
    deadline 1 and the others 0. ``weight=None`` materializes uniform
    weights.
    """
    cid = _host(class_id).astype(np.int64)
    if weight is None:
        weight = np.ones((int(np.max(cid)) + 1,), np.float32)
    d = None
    if deadline is not None:
        d = np.asarray(
            [np.inf if v is None else float(v) for v in deadline], np.float32
        )
        if tail_weight is None:
            tail_weight = np.where(np.isfinite(d), 1.0, 0.0)
    on = lambda x, dtype=torch.float32: None if x is None else torch.as_tensor(
        np.asarray(x), dtype=dtype, device=device
    )
    spec = ObjectiveSpec(
        class_id=on(cid, torch.int64), weight=on(np.asarray(weight, np.float32)),
        deadline=on(d), tail_weight=on(tail_weight),
    )
    spec.validate()
    return spec


class CacheSpec(NamedTuple):
    """Hot-tier cache view of the solver: per-file hit rates + hot costs.

    ``hit``         (r,) per-file hot-cache hit probability h_i in [0, 1).
    ``hit_latency`` ()  latency of a cache hit (hot tier service time).
    ``hot_cost``    ()  storage cost of the replicated hot tier (constant in
                    pi: it joins ``JLCMSolution.cost`` and ``objective`` but
                    never moves the argmin).
    """

    hit: Tensor
    hit_latency: Tensor
    hot_cost: Tensor


def make_cache_spec(
    hit: Sequence[float] | Tensor,
    hit_latency: float = 0.0,
    hot_cost: float = 0.0,
    *,
    device: str | torch.device = "cuda",
) -> CacheSpec:
    """Validated :class:`CacheSpec` on ``device``. Hit rates are clamped to
    [0, 1 - 1e-6] so a fully cached file cannot zero the warm-tier fold."""
    h = _host(hit).astype(np.float32)
    if h.ndim != 1:
        raise ValueError(f"hit must be (r,), got shape {h.shape}")
    if (h < 0).any() or (h > 1).any():
        raise ValueError("hit rates must lie in [0, 1]")
    if float(hit_latency) < 0:
        raise ValueError("hit_latency must be >= 0")
    if float(hot_cost) < 0:
        raise ValueError("hot_cost must be >= 0")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return CacheSpec(
        hit=f32(np.minimum(h, np.float32(1.0 - 1e-6))),
        hit_latency=f32(float(hit_latency)),
        hot_cost=f32(float(hot_cost)),
    )


def apply_cache_thinning(lam: Tensor, cache: CacheSpec | None) -> Tensor:
    """Warm-tier (miss) arrival rates ``lam_i (1 - h_i)``; ``cache=None``
    returns ``lam`` itself (no op)."""
    if cache is None:
        return lam
    return lam * (1.0 - cache.hit)


def _cache_blend(
    lam: Tensor, wf: Tensor | None, cache: CacheSpec, mean_term: Tensor
) -> Tensor:
    """Hit/miss blend of the warm-tier mean objective (see module doc)."""
    wlam = lam if wf is None else lam * wf
    w_tot = torch.sum(wlam, dim=-1)
    w_miss = torch.sum(wlam * (1.0 - cache.hit), dim=-1)
    hit_term = torch.sum(wlam * cache.hit, dim=-1) * cache.hit_latency
    return (w_miss / w_tot) * mean_term + hit_term / w_tot


def _class_sums(class_id: Tensor, values: Tensor, n_classes: int) -> Tensor:
    """Segment-sum of per-file ``values`` (..., r) into (..., C) totals."""
    classes = torch.arange(n_classes, device=class_id.device)
    onehot = (class_id[..., None] == classes).to(values.dtype)
    return torch.sum(onehot * values[..., None], dim=-2)


def class_tail_bounds(
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    lam: Tensor,
    spec: ObjectiveSpec,
    lam_total: Tensor | None = None,
) -> Tensor | None:
    """Per-class tail bounds, (..., C): request-rate-weighted over the class.

    ``P-bound[T_c > d_c] = sum_{i in c} lam_i tail_i / sum_{i in c} lam_i``
    with per-file ``tail_i`` from ``tail_probability_bounds`` at the class
    deadline. Infinite deadlines are computed against a finite stand-in and
    masked to exactly 0 (keeps gradients NaN-free). None when the spec has
    no tail terms. ``lam_total`` replaces the denominator's rates (the cache
    tier's per-request bound: thinned numerator, raw denominator).
    """
    if spec.deadline is None:
        return None
    d_file = spec.file_deadlines()
    finite = torch.isfinite(d_file)
    d_safe = torch.where(finite, d_file, 1.0)
    tails = tail_probability_bounds(pi, eq, varq, d_safe, instance_ndim=2)
    tails = torch.where(finite, tails, 0.0)
    num = _class_sums(spec.class_id, lam * tails, spec.n_classes)
    den = _class_sums(
        spec.class_id, lam if lam_total is None else lam_total, spec.n_classes
    )
    return num / torch.clamp_min(den, 1e-12)


def tail_penalty(
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    lam: Tensor,
    spec: ObjectiveSpec,
    lam_total: Tensor | None = None,
) -> Tensor:
    """``sum_c tw_c * P-bound[T_c > d_c]``; 0.0 when the spec has no tails."""
    per_class = class_tail_bounds(pi, eq, varq, lam, spec, lam_total)
    if per_class is None:
        return pi.new_zeros(())
    active = torch.isfinite(spec.deadline) & (spec.tail_weight > 0)
    return torch.sum(torch.where(active, spec.tail_weight * per_class, 0.0), dim=-1)


def composed_latency(
    pi: Tensor,
    z: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    spec: ObjectiveSpec | None,
    geo: GeoSpec | None = None,
    cache: CacheSpec | None = None,
    *,
    background: Tensor | None = None,
) -> Tensor:
    """The solver-facing latency objective at shared auxiliary z.

    Weighted shared-z mean (Eq. 9 fold) plus the tail penalty; the tail
    terms carry their own per-file z, so the shared z parameterizes the
    mean term only. ``geo`` folds over (file, node) pairs; ``cache``
    evaluates the warm-tier fold at the thinned rates and blends hits back
    in; ``background`` ((..., m) node rates of rows frozen outside this
    problem) joins the P-K moments but never the fold weights. With every
    option ``None`` this IS ``shared_z_latency``, op for op.
    """
    wf = None if spec is None else spec.file_weights()
    lam_eff = apply_cache_thinning(lam, cache)
    if geo is not None:
        mean_term = geo_shared_z_latency(pi, z, lam_eff, geo, weights=wf)
        if cache is not None:
            mean_term = _cache_blend(lam, wf, cache, mean_term)
        if spec is None or spec.deadline is None:
            return mean_term
        eq, varq = geo_eq_varq(pi, lam_eff, geo)
        return mean_term + tail_penalty(
            pi, eq, varq, lam_eff, spec, lam_total=None if cache is None else lam,
        )
    if spec is None and cache is None:
        return shared_z_latency(pi, z, lam, moments, extra_rates=background)
    mean_term = shared_z_latency(
        pi, z, lam_eff, moments, weights=wf, extra_rates=background
    )
    if cache is not None:
        mean_term = _cache_blend(lam, wf, cache, mean_term)
    if spec is None or spec.deadline is None:
        return mean_term
    rates = node_arrival_rates(pi, lam_eff)
    if background is not None:
        rates = rates + background
    eq, varq = pk_sojourn_moments(rates, moments)
    return mean_term + tail_penalty(
        pi, eq[..., None, :], varq[..., None, :], lam_eff, spec,
        lam_total=None if cache is None else lam,
    )


def refresh_shared_z(
    pi: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    spec: ObjectiveSpec | None,
    geo: GeoSpec | None = None,
    cache: CacheSpec | None = None,
    *,
    background: Tensor | None = None,
) -> Tensor:
    """argmin_z of :func:`composed_latency`: the solver's z-refresh step.

    The tail penalty does not depend on the shared z, and with a cache the
    mean term is a positive multiple of the warm fold plus a z-free hit
    term, so minimizing the (weighted) warm fold alone is exact.
    """
    wf = None if spec is None else spec.file_weights()
    lam_eff = apply_cache_thinning(lam, cache)
    if geo is not None:
        return geo_optimal_shared_z(pi, lam_eff, geo, weights=wf)
    return optimal_shared_z(pi, lam_eff, moments, weights=wf, extra_rates=background)


def _blend_hits(t_files: Tensor, cache: CacheSpec) -> Tensor:
    """Per-file bounds blended with hits: ``(1 - h_i) t_i + h_i t_hit``."""
    return (1.0 - cache.hit) * t_files + cache.hit * cache.hit_latency[..., None]


def compose_file_bounds(
    t_files: Tensor,
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    lam: Tensor,
    spec: ObjectiveSpec | None,
    cache: CacheSpec | None = None,
) -> Tensor:
    """Composed objective value from per-file tight bounds (reporting).

    :func:`composed_latency` with the per-file-z Lemma-2 bounds ``t_files``
    in place of the shared-z relaxation. With a cache, ``eq``/``varq`` are
    the thinned-rate sojourn moments and per-file bounds are blended with
    the hit latency before the weighted fold.
    """
    if cache is not None:
        t_files = _blend_hits(t_files, cache)
    if spec is None:
        return torch.sum(lam * t_files, dim=-1) / torch.sum(lam, dim=-1)
    wf = spec.file_weights()
    wlam = lam if wf is None else lam * wf
    mean_term = torch.sum(wlam * t_files, dim=-1) / torch.sum(wlam, dim=-1)
    if spec.deadline is None:
        return mean_term
    lam_eff = apply_cache_thinning(lam, cache)
    return mean_term + tail_penalty(
        pi, eq, varq, lam_eff, spec, lam_total=None if cache is None else lam,
    )


def class_mean_bounds(t_files: Tensor, lam: Tensor, spec: ObjectiveSpec) -> Tensor:
    """Per-class request-weighted mean of per-file bounds, shape (..., C)."""
    num = _class_sums(spec.class_id, lam * t_files, spec.n_classes)
    den = _class_sums(spec.class_id, lam, spec.n_classes)
    return num / torch.clamp_min(den, 1e-12)


def empirical_objective_device(
    latency: Tensor,
    file_id: Tensor,
    spec: ObjectiveSpec | None,
    valid: Tensor | None = None,
) -> Tensor:
    """The composed objective on a simulated latency stream (..., N), where
    the stream lives (no host round trip): the device twin of
    :func:`empirical_objective`, one score per stream of the leading axes.

    ``valid`` masks requests out of the statistic. Per-class exceedance
    follows the host contract: a class with no (valid) request contributes
    0, and ``tw_c == 0`` or an infinite deadline disables a class's term.
    """
    latency = latency.to(torch.float32)
    vf = (
        torch.ones_like(latency) if valid is None
        else torch.as_tensor(valid, device=latency.device).to(torch.float32)
    )
    lat = torch.where(vf > 0, latency, 0.0)  # keep masked +-inf out of sums
    if spec is None:
        return torch.sum(lat * vf, dim=-1) / torch.clamp_min(torch.sum(vf, dim=-1), 1.0)
    cid = spec.class_id[file_id]
    w = vf if spec.weight is None else spec.weight[cid] * vf
    score = torch.sum(w * lat, dim=-1) / torch.clamp_min(torch.sum(w, dim=-1), 1e-30)
    if spec.deadline is not None:
        classes = torch.arange(spec.n_classes, device=cid.device)
        onehot = (cid[..., None] == classes) * vf[..., None]  # (..., N, C)
        count = torch.sum(onehot, dim=-2)
        exceed = torch.sum(onehot * (lat[..., None] > spec.deadline), dim=-2)
        frac = torch.where(count > 0, exceed / torch.clamp_min(count, 1.0), 0.0)
        score = score + torch.sum(spec.tail_weight * frac, dim=-1)
    return score


def empirical_objective(latency, file_id, spec: ObjectiveSpec | None) -> float:
    """The composed objective on simulated latencies (host numpy).

    Per-request weights ``w_{c_i}`` give the weighted mean (request counts
    already carry the lam_i proportions), and per-class exceedance
    frequencies stand in for the tail bounds.
    """
    latency = _host(latency).ravel()
    if spec is None:
        return float(latency.mean())
    cid = _host(spec.class_id)[_host(file_id).ravel()]
    w = np.ones_like(latency) if spec.weight is None else _host(spec.weight)[cid]
    score = float((w * latency).sum() / w.sum())
    if spec.deadline is not None:
        d = _host(spec.deadline)
        tw = _host(spec.tail_weight)
        for c in range(spec.n_classes):
            if not (np.isfinite(d[c]) and tw[c] > 0):
                continue
            in_c = cid == c
            if in_c.any():
                score += float(tw[c]) * float((latency[in_c] > d[c]).mean())
    return score
