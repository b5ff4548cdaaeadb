"""Online latency statistics: streaming moments + log-spaced quantile sketch.

Constant-size accumulators that fold a block of latencies at a time and
merge associatively, so a horizon need not be materialized and per-shard
statistics combine:

**Moments**: count / running mean / M2 (sum of squared deviations from
the running mean), Welford's algorithm in its batched (Chan et al.) form;
two accumulators over disjoint blocks merge with

    n      = n_a + n_b
    mean   = mean_a + (mean_b - mean_a) * n_b / n
    M2     = M2_a + M2_b + (mean_b - mean_a)^2 * n_a * n_b / n

**Quantile sketch**: a fixed histogram over log-spaced bins. With
``bins`` buckets spanning ``[lo, hi)`` the growth factor is
``g = (hi/lo)**(1/bins)`` and bucket ``b`` covers ``[lo*g^(b-1), lo*g^b)``;
two clamp buckets catch ``x < lo`` and ``x >= hi``. :func:`stream_quantile`
returns the upper edge of the bucket holding the rank-``ceil(q*n)`` order
statistic, so for values in the regular range

    x_(ceil(q*n))  <=  estimate  <=  g * x_(ceil(q*n))

(:attr:`SketchSpec.rel_error` = g - 1, 3.2% at the 512-bin default over
1 ms..10^4 s). Values below ``lo`` resolve to ``lo``; the overflow bucket
resolves to the tracked maximum.

**Exactness.** ``count``, ``hist``, ``minv`` and ``maxv`` are exact:
``hist`` is an int32 ``scatter_add_``, and integer addition gives the same
sum in any order (CUDA's atomics included), so merged sketches equal the
single-pass sketch. Bucket indices come from ``torch.searchsorted(edges,
x, right=True)`` on the float32 edges, the rule of the reference's
``jnp.searchsorted(side="right")``. ``mean`` and ``m2`` are float32 and
agree with the reference within float32 rounding (sums in another order).

Every function takes leading batch axes: a fleet carries (S,)-batched
stats, per-window stats (S, W). :class:`StreamingStats` holds tensors
only; the bin geometry lives in the frozen :class:`SketchSpec`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .cluster import _device


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Bin geometry of the quantile sketch.

    ``lo``/``hi`` bound the regular log-spaced range; latencies outside land
    in clamp buckets (below: resolve to ``lo``; above: resolve to the
    tracked max). ``bins`` regular buckets give a per-quantile relative
    error bound of ``(hi/lo)**(1/bins) - 1``.
    """

    lo: float = 1e-3
    hi: float = 1e4
    bins: int = 512

    def __post_init__(self):
        if not (0.0 < self.lo < self.hi):
            raise ValueError(f"need 0 < lo < hi, got {self.lo}, {self.hi}")
        if self.bins < 1:
            raise ValueError(f"need >= 1 bin, got {self.bins}")

    @property
    def growth(self) -> float:
        """Per-bucket growth factor ``g``."""
        return (self.hi / self.lo) ** (1.0 / self.bins)

    @property
    def rel_error(self) -> float:
        """One-sided relative quantile error bound, ``g - 1``."""
        return self.growth - 1.0

    @property
    def n_buckets(self) -> int:
        """Total buckets including the two clamp buckets."""
        return self.bins + 2

    @functools.cached_property
    def edges(self) -> np.ndarray:
        """(bins + 1,) ascending bucket edges ``lo * g**i`` (float64 host
        constant)."""
        return self.lo * self.growth ** np.arange(self.bins + 1)

    def edges_on(self, device: torch.device) -> Tensor:
        """The edges as float32 on ``device``, as the bucket search uses them
        (copied there once per device, so later folds make no copy)."""
        cache = self.__dict__.setdefault("_edges_on", {})
        if device not in cache:
            cache[device] = torch.as_tensor(self.edges, dtype=torch.float32, device=device)
        return cache[device]


DEFAULT_SKETCH = SketchSpec()


class StreamingStats(NamedTuple):
    """Constant-size latency accumulators, all with one leading batch shape
    ``(...)``. ``count``/``hist`` are exact int32 counts; ``mean``/``m2`` are
    float32 Welford state; ``minv``/``maxv`` the observed range (+inf/-inf
    when empty)."""

    count: Tensor  # (...,) int32 values folded
    mean: Tensor  # (...,) running mean
    m2: Tensor  # (...,) sum of squared deviations from the mean
    minv: Tensor  # (...,) smallest value seen (+inf when empty)
    maxv: Tensor  # (...,) largest value seen (-inf when empty)
    hist: Tensor  # (..., bins + 2) int32 bucket counts


def stream_init(
    spec: SketchSpec = DEFAULT_SKETCH,
    batch_shape: tuple[int, ...] = (),
    *,
    device: str | torch.device = "cuda",
) -> StreamingStats:
    """Empty accumulators with the given leading batch shape on ``device``."""
    dev = _device(device)
    f32 = lambda v: torch.full(batch_shape, v, dtype=torch.float32, device=dev)
    return StreamingStats(
        count=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
        mean=f32(0.0),
        m2=f32(0.0),
        minv=f32(torch.inf),
        maxv=f32(-torch.inf),
        hist=torch.zeros(
            batch_shape + (spec.n_buckets,), dtype=torch.int32, device=dev
        ),
    )


def stream_fold(
    stats: StreamingStats,
    x: Tensor,
    spec: SketchSpec = DEFAULT_SKETCH,
    *,
    include: Tensor | None = None,
) -> StreamingStats:
    """Fold a block of values into the accumulators (one vectorized pass).

    ``x`` is (..., K) with leading axes matching ``stats``; ``include``
    (same shape, bool) masks values out of the fold. The block's own
    moments are computed vectorized, then merged with the carried state.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    inc = (
        torch.ones(x.shape, dtype=torch.bool, device=x.device)
        if include is None
        else torch.as_tensor(include, dtype=torch.bool, device=x.device)
    )
    incf = inc.to(torch.float32)
    n_b = torch.sum(inc, dim=-1, dtype=torch.int32)
    n_bf = torch.clamp_min(n_b.to(torch.float32), 1.0)
    mean_b = torch.sum(x * incf, dim=-1) / n_bf
    dev = torch.where(inc, x - mean_b[..., None], 0.0)
    m2_b = torch.sum(dev * dev, dim=-1)
    min_b = torch.amin(torch.where(inc, x, torch.inf), dim=-1)
    max_b = torch.amax(torch.where(inc, x, -torch.inf), dim=-1)

    idx = torch.searchsorted(spec.edges_on(x.device), x, right=True)  # [0, bins+1]
    # masked-out values go to bucket 0 with weight 0
    hist_b = _scatter_counts(
        torch.where(inc, idx, 0), inc.to(torch.int32), spec.n_buckets
    )
    block = StreamingStats(
        count=n_b, mean=mean_b, m2=m2_b, minv=min_b, maxv=max_b, hist=hist_b
    )
    return stream_merge(stats, block)


def _scatter_counts(idx: Tensor, weights: Tensor, n_buckets: int) -> Tensor:
    """Histogram of ``idx`` (..., K) with int32 ``weights`` into
    (..., n_buckets): an integer scatter-add, exact in any order."""
    flat_idx = idx.reshape(-1, idx.shape[-1])
    flat_w = weights.reshape(-1, weights.shape[-1])
    out = torch.zeros(
        (flat_idx.shape[0], n_buckets), dtype=torch.int32, device=idx.device
    )
    out.scatter_add_(1, flat_idx, flat_w)
    return out.reshape(idx.shape[:-1] + (n_buckets,))


def stream_merge(a: StreamingStats, b: StreamingStats) -> StreamingStats:
    """Combine two accumulators over disjoint value sets (associative).

    Histogram, count, min and max merge exactly; moments by the batched
    Welford combine. An empty side is an identity element.
    """
    n_a = a.count.to(torch.float32)
    n_b = b.count.to(torch.float32)
    n = n_a + n_b
    nf = torch.clamp_min(n, 1.0)
    delta = b.mean - a.mean
    mean = torch.where(n > 0, a.mean + delta * n_b / nf, 0.0)
    m2 = a.m2 + b.m2 + delta * delta * n_a * n_b / nf
    return StreamingStats(
        count=a.count + b.count,
        mean=mean,
        m2=torch.where(n > 0, m2, 0.0),
        minv=torch.minimum(a.minv, b.minv),
        maxv=torch.maximum(a.maxv, b.maxv),
        hist=a.hist + b.hist,
    )


def stream_reduce(stats: StreamingStats, axis: int = 0) -> StreamingStats:
    """Merge accumulators along a batch axis (e.g. a fleet's seed axis) in
    one vectorized pass, the generalized Chan combine:

        n = sum n_i;  mean = sum(n_i mean_i)/n;
        M2 = sum M2_i + sum n_i (mean_i - mean)^2
    """
    n_i = stats.count.to(torch.float32)
    n = torch.sum(n_i, dim=axis)
    nf = torch.clamp_min(n, 1.0)
    mean = torch.sum(n_i * stats.mean, dim=axis) / nf
    mean = torch.where(n > 0, mean, 0.0)
    dev = stats.mean - mean.unsqueeze(axis)
    m2 = torch.sum(stats.m2 + n_i * dev * dev, dim=axis)
    return StreamingStats(
        count=torch.sum(stats.count, dim=axis, dtype=torch.int32),
        mean=mean,
        m2=torch.where(n > 0, m2, 0.0),
        minv=torch.amin(stats.minv, dim=axis),
        maxv=torch.amax(stats.maxv, dim=axis),
        hist=torch.sum(
            stats.hist, dim=axis if axis >= 0 else axis - 1, dtype=torch.int32
        ),
    )


def stream_mean(stats: StreamingStats) -> Tensor:
    """Running mean; NaN for empty accumulators."""
    return torch.where(stats.count > 0, stats.mean, torch.nan)


def stream_var(stats: StreamingStats) -> Tensor:
    """Population variance (ddof=0); NaN if empty."""
    return torch.where(
        stats.count > 0,
        stats.m2 / torch.clamp_min(stats.count.to(torch.float32), 1.0),
        torch.nan,
    )


def stream_quantile(
    stats: StreamingStats, q: float, spec: SketchSpec = DEFAULT_SKETCH
) -> Tensor:
    """Sketch quantile: upper edge of the bucket holding the rank-
    ``ceil(q * count)`` order statistic (the rank in float32), clamped to
    the observed max.

    The estimate is >= the true order statistic and overshoots it by at
    most a factor ``spec.growth`` for values in ``[lo, hi)``; below-range
    values resolve to ``lo``, above-range to the observed maximum. NaN for
    empty stats. Vectorized over leading batch axes.
    """
    count = stats.count.to(torch.float32)
    rank = torch.clamp(torch.ceil(q * count), min=1.0)
    rank = torch.minimum(rank, torch.clamp_min(count, 1.0))
    cum = torch.cumsum(stats.hist, dim=-1).to(torch.float32)
    b = torch.sum(cum < rank[..., None], dim=-1)  # first bucket with cum >= rank
    edges = spec.edges_on(stats.hist.device)
    est = torch.minimum(edges[torch.clamp(b, 0, spec.bins)], stats.maxv)
    est = torch.where(b > spec.bins, stats.maxv, est)
    return torch.where(stats.count > 0, est, torch.nan)


def stream_from_values(
    x: Tensor,
    spec: SketchSpec = DEFAULT_SKETCH,
    *,
    include: Tensor | None = None,
) -> StreamingStats:
    """Accumulators of a materialized block, on the block's device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    init = stream_init(spec, tuple(x.shape[:-1]), device=x.device)
    return stream_fold(init, x, spec, include=include)


def windowed_quantile_mean(
    windows: StreamingStats, q: float = 0.99, spec: SketchSpec = DEFAULT_SKETCH
) -> Tensor:
    """Mean of per-window sketch quantiles over the LAST batch axis (the
    mean of per-segment p99s an SLO dashboard shows). Empty windows are
    skipped (NaN-mean)."""
    return torch.nanmean(stream_quantile(windows, q, spec), dim=-1)
