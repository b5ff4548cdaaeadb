"""Hot/warm cache tier: the Che/TTL hit-rate model and a simulated TTL cache.

Production blob stores do not send every read to the erasure-coded tier:
Facebook's Haystack/f4 split serves most reads from a *replicated* hot
cache (effective storage overhead ~3.6x) and only the misses from the
erasure-coded warm tier (~2.1x). This module supplies both halves of that
tier.

**Analytic model (control plane, host float64 numpy).** An LRU cache of
capacity ``B`` under independent Poisson(lam_i) per-file arrivals behaves,
by the Che approximation, like a TTL cache with *reset on access* whose
TTL is the characteristic time ``T_C`` solving the capacity fixed point

    sum_i  size_i * (1 - exp(-lam_i * T_C))  =  B

and the per-file hit probability is ``h_i = 1 - exp(-lam_i * T_C)``.
:class:`CacheModel` solves the fixed point by bisection, exposes per-file
hit rates and thinned miss rates, reconstructs raw rates from miss-only
observations, and packages everything as a ``core.objectives.CacheSpec``
for the JLCM solver.

**Simulated cache (data plane, on the simulated device).**
:func:`ttl_cache_scan` runs the exact TTL-with-reset surrogate over a
merged arrival stream: a read of file ``i`` at time ``t`` hits iff the
file was last read within ``ttl_i`` (or, for its first read, before the
carried expiry), and every read refreshes the expiry. The walk needs no
loop over requests: a stable sort on file id puts each read next to the
previous read of the same file, so every hit and the new expiries come
from one sort, two gathers and one scatter. The segmented simulator
(``storage/simulator.py``) runs it in front of its FCFS queues: hits
return at the hot tier's latency and never reach the warm-tier queues; a
per-file ``ttl`` of 0 (a demoted file, a repair row, or a hot-tier outage)
disables caching for that file without changing any random draw, so a
run with ``ttl`` all zero is bitwise the cache-free run.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.objectives import CacheSpec, make_cache_spec

from .cluster import _device

# f4's effective storage overheads: the replicated hot tier keeps 3.6x the
# logical bytes (3 replicas + RAID-6 style local redundancy), the
# erasure-coded warm tier ~2.1x (RS(10, 4) across racks).
HOT_REPLICATION = 3.6
WARM_OVERHEAD = 2.1

MB = float(2**20)


def che_characteristic_time(
    lam: np.ndarray,
    size_bytes: np.ndarray,
    capacity_bytes: float,
    *,
    iters: int = 80,
) -> float:
    """Solve the Che capacity fixed point for the characteristic time.

    Returns the ``T_C`` with ``sum_i size_i (1 - exp(-lam_i T_C)) ==
    capacity``; 0.0 when the capacity is 0 and ``inf`` when the whole
    active catalog fits (every file with lam_i > 0 always hits). Occupancy
    is monotone in T, so bisection converges geometrically; ``iters=80``
    takes the bracket below float64 resolution.
    """
    lam = np.asarray(lam, np.float64)
    size = np.asarray(size_bytes, np.float64)
    if lam.shape != size.shape:
        raise ValueError(f"lam {lam.shape} and sizes {size.shape} must match")
    cap = float(capacity_bytes)
    if cap <= 0.0:
        return 0.0
    active = lam > 0
    if float(size[active].sum()) <= cap:
        return np.inf

    def occupancy(t: float) -> float:
        return float(np.sum(size * -np.expm1(-lam * t)))

    hi = 1.0
    while occupancy(hi) < cap:
        hi *= 2.0
    lo = 0.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if occupancy(mid) < cap:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def che_hit_rates(lam: np.ndarray, ttl: np.ndarray | float) -> np.ndarray:
    """Per-file hit probability ``1 - exp(-lam_i ttl_i)`` (NaN-safe).

    ``ttl`` may be a scalar characteristic time or a per-file vector (the
    admission-controlled cache sets demoted files to 0). ``lam == 0`` or
    ``ttl == 0`` give exactly 0; ``ttl == inf`` gives 1 for active files.
    """
    lam = np.asarray(lam, np.float64)
    ttl = np.broadcast_to(np.asarray(ttl, np.float64), lam.shape)
    h = np.where(
        np.isinf(ttl), np.where(lam > 0, 1.0, 0.0), -np.expm1(-lam * ttl)
    )
    return np.where(lam > 0, h, 0.0)


@dataclasses.dataclass(frozen=True)
class CacheModel:
    """Control-plane view of one hot-tier cache (capacity in bytes).

    ``file_bytes`` are the logical object sizes; the replicated hot tier
    stores ``hot_replication`` times the bytes it caches and the price of
    the *provisioned* capacity is what the latency-cost objective charges
    (``hot_cost``), so a capacity sweep trades hot spend against warm-tier
    latency — the f4 hot/warm placement knob.

    ``admit_min_hit`` is the promotion/demotion threshold: files whose
    transparent-LRU hit rate would fall below it are demoted (per-file
    ttl 0), freeing capacity — the characteristic time is re-solved over
    the admitted set only, so surviving hot files get *longer* residency.
    0 disables admission control (a transparent LRU).
    """

    file_bytes: np.ndarray
    capacity_bytes: float
    hit_latency: float = 0.5
    hot_price_per_mb: float = 0.0
    hot_replication: float = HOT_REPLICATION
    admit_min_hit: float = 0.0

    def __post_init__(self) -> None:
        fb = np.asarray(self.file_bytes, np.float64)
        object.__setattr__(self, "file_bytes", fb)
        if fb.ndim != 1 or (fb <= 0).any():
            raise ValueError("file_bytes must be a (r,) vector of positive sizes")
        if self.capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        if self.hit_latency < 0:
            raise ValueError("hit_latency must be >= 0")
        if not 0.0 <= self.admit_min_hit < 1.0:
            raise ValueError("admit_min_hit must lie in [0, 1)")

    @property
    def r(self) -> int:
        return int(self.file_bytes.shape[0])

    def admitted(self, lam: np.ndarray) -> np.ndarray:
        """(r,) bool: files hot enough to keep in the cache."""
        if self.admit_min_hit <= 0.0:
            return np.ones((self.r,), bool)
        t_all = che_characteristic_time(
            lam, self.file_bytes, self.capacity_bytes
        )
        return che_hit_rates(lam, t_all) >= self.admit_min_hit

    def ttl(self, lam: np.ndarray) -> np.ndarray:
        """(r,) per-file TTL: the Che characteristic time over the admitted
        set, 0 for demoted files — what the simulated cache consumes."""
        lam = np.asarray(lam, np.float64)
        if lam.shape != (self.r,):
            raise ValueError(f"lam must be ({self.r},), got {lam.shape}")
        admit = self.admitted(lam)
        t_c = che_characteristic_time(
            np.where(admit, lam, 0.0), self.file_bytes, self.capacity_bytes
        )
        return np.where(admit, t_c, 0.0)

    def hit_rates(self, lam: np.ndarray) -> np.ndarray:
        """(r,) analytic per-file hit probability at raw rates ``lam``."""
        return che_hit_rates(lam, self.ttl(lam))

    def thin(self, lam: np.ndarray) -> np.ndarray:
        """Warm-tier (miss) arrival rates ``lam_i (1 - h_i)``."""
        return np.asarray(lam, np.float64) * (1.0 - self.hit_rates(lam))

    def reconstruct_raw_rates(
        self,
        miss_rates: np.ndarray,
        ttl: np.ndarray,
        *,
        prior: np.ndarray | None = None,
        cache_up: bool = True,
        iters: int = 60,
    ) -> np.ndarray:
        """Invert the thinning: raw rates from miss-only observations.

        The warm tier's estimators only see miss traffic (hits are served
        by the hot tier and never reach a storage queue), but planning the
        hot/warm split needs the *raw* rates. The control plane knows the
        per-file ``ttl`` it deployed, so each file solves

            miss_i = raw_i * exp(-raw_i * ttl_i)

        This map is two-branched (it peaks at ``raw = 1/ttl``): a given
        miss rate could come from a lukewarm file or a scorching one whose
        hits hide almost all its traffic. ``prior`` — the previous raw
        estimate, tracked across replans — selects the branch; each branch
        is monotone, so bisection is exact. A miss rate above the peak
        ``e^{-1}/ttl`` (sampling noise) clamps to the peak. Files with
        ``ttl == 0`` are uncached (raw == miss) and ``ttl == inf`` files
        are unobservable from miss traffic alone (fall back to the prior).
        With the hot tier down (``cache_up=False``) observed traffic IS
        raw traffic and the inversion is the identity.

        Conditioning: the log-log sensitivity of the miss rate to the raw
        rate is ``d ln miss / d ln raw = 1 - raw * ttl``, which VANISHES
        at the peak — a file operating near ``raw ~ 1/ttl`` (hit rate
        ~63%) tells the observer almost nothing about its raw rate, and
        naive inversion amplifies EWMA noise into wild raw swings there.
        When a ``prior`` is supplied, the bisection result is therefore
        blended toward it with weight ``clip(|1 - raw*ttl|, 0.1, 1)``:
        full trust where the observation is informative (including
        ``ttl == 0``, where misses ARE raw), prior-dominated (but still
        tracking persistent drift at >= 10% per call) in the blind spot.
        An exactly-consistent observation (``miss == raw * e^{-raw*ttl}``
        at ``raw == prior``) is a fixed point regardless of the weight,
        so noiseless round trips stay exact.
        """
        miss = np.maximum(np.asarray(miss_rates, np.float64), 0.0)
        if not cache_up:
            return miss
        ttl = np.broadcast_to(np.asarray(ttl, np.float64), miss.shape)
        have_prior = prior is not None
        prior = miss if prior is None else np.asarray(prior, np.float64)
        raw = miss.copy()
        for i in range(miss.shape[0]):
            t, m = ttl[i], miss[i]
            if t <= 0.0 or m <= 0.0:
                continue
            if np.isinf(t):
                raw[i] = prior[i]
                continue
            peak = 1.0 / t
            if m >= peak * np.exp(-1.0):
                est = peak
            else:
                f = lambda x: x * np.exp(-x * t)
                if prior[i] <= peak:  # low branch: f increasing on [0, peak]
                    lo, hi = m, peak
                    for _ in range(iters):
                        mid = 0.5 * (lo + hi)
                        lo, hi = (mid, hi) if f(mid) < m else (lo, mid)
                else:  # high branch: f decreasing on [peak, inf)
                    lo, hi = peak, max(2.0 * prior[i], 4.0 * peak)
                    while f(hi) > m:
                        hi *= 2.0
                    for _ in range(iters):
                        mid = 0.5 * (lo + hi)
                        lo, hi = (mid, hi) if f(mid) > m else (lo, mid)
                est = 0.5 * (lo + hi)
            if have_prior:
                w = np.clip(abs(1.0 - est * t), 0.1, 1.0)
                est = w * est + (1.0 - w) * prior[i]
            raw[i] = est
        return raw

    def expected_hot_bytes(self, lam: np.ndarray) -> float:
        """Expected cache occupancy sum_i size_i h_i (<= capacity)."""
        return float(np.sum(self.file_bytes * self.hit_rates(lam)))

    def hot_cost(self) -> float:
        """Storage cost of the provisioned hot tier (capacity, replicated).

        Charged on provisioned capacity, not instantaneous occupancy: the
        hot tier's hardware is paid for whether or not the cache is warm,
        and it is the same constant for every dispatch policy sharing the
        cache — cost differences between policies come from the warm tier.
        """
        return float(
            self.hot_replication * (self.capacity_bytes / MB)
            * self.hot_price_per_mb
        )

    def spec(
        self,
        lam: np.ndarray,
        *,
        extra_rows: int = 0,
        device: str | torch.device = "cuda",
    ) -> CacheSpec:
        """Solver-facing :class:`~repro_torch.core.objectives.CacheSpec` on
        ``device``.

        ``extra_rows`` appends that many zero-hit rows — repair pseudo-file
        rows (ids >= r) are reconstruction reads of *lost* chunks and must
        never be cache-thinned.
        """
        hit = self.hit_rates(lam)
        if extra_rows:
            hit = np.concatenate([hit, np.zeros((extra_rows,))])
        return make_cache_spec(
            hit, hit_latency=self.hit_latency, hot_cost=self.hot_cost(),
            device=device,
        )


# ---------------------------------------------------------------------------
# Simulated cache (TTL with reset on access), on the simulated device.
# ---------------------------------------------------------------------------


class CacheState(NamedTuple):
    """Cache contents as per-file absolute expiry times.

    ``expiry[..., i]`` is the time before which a read of file ``i`` hits;
    a cold cache is all ``-inf``. One (..., r) tensor is the whole cache —
    the TTL surrogate needs no eviction list.
    """

    expiry: Tensor


def cold_cache(r: int, *, device: str | torch.device = "cuda") -> CacheState:
    return CacheState(
        expiry=torch.full((r,), -torch.inf, dtype=torch.float32, device=_device(device))
    )


def ttl_cache_scan(
    expiry: Tensor, t: Tensor, file_id: Tensor, ttl: Tensor
) -> tuple[Tensor, Tensor]:
    """Run the TTL-with-reset cache over an arrival stream.

    ``expiry`` is the (..., r) cache state (an (r,) state is shared by
    every leading index), ``t``/``file_id`` the (..., N) merged arrival
    stream (absolute times) and ``ttl`` the (r,) or (..., r) per-file
    TTLs; leading axes are independent systems (a seed batch). Returns
    ``(new_expiry, hits)``, hits (..., N) bool.

    Request n of file f hits iff ``ttl[f] > 0`` and ``t_n < e``, where
    ``e`` is the expiry the previous read of f set (its arrival plus
    ``ttl[f]``, in float32) or, for f's first read in the stream, the
    carried ``expiry[f]``. A stable sort on file id puts each read right
    after the previous read of its file, so the sequential scan's result
    comes out of one sort, two gathers and a scatter, bit for bit: the
    comparisons and the one float32 add are the scan's own. Each read
    file's new expiry is its last arrival plus its TTL; a file not read
    keeps its carried expiry. Consumes no randomness. A file with
    ``ttl == 0`` never hits, not even on warmth carried from an earlier
    segment, so a zero TTL is an invalidation.
    """
    lead = t.shape[:-1]
    r = expiry.shape[-1]
    expiry = expiry.expand(lead + (r,))
    ttl = torch.as_tensor(ttl, dtype=torch.float32, device=t.device).expand(lead + (r,))
    f_s, order = torch.sort(file_id, dim=-1, stable=True)
    t_s = torch.gather(t, -1, order)
    ttl_s = torch.gather(ttl, -1, f_s)
    refreshed = t_s + ttl_s  # the expiry each read leaves behind
    first = torch.ones_like(f_s, dtype=torch.bool)
    first[..., 1:] = f_s[..., 1:] != f_s[..., :-1]
    carried = torch.gather(expiry, -1, f_s)
    previous = torch.cat([carried[..., :1], refreshed[..., :-1]], dim=-1)
    e = torch.where(first, carried, previous)
    hits = torch.empty_like(first).scatter_(-1, order, (t_s < e) & (ttl_s > 0.0))
    # each file's last read writes its expiry; every other read writes to
    # a spare column r, dropped after
    last = torch.ones_like(first)
    last[..., :-1] = first[..., 1:]
    slot = torch.where(last, f_s, r)
    new_expiry = torch.cat([expiry, expiry[..., :1]], dim=-1).scatter(-1, slot, refreshed)
    return new_expiry[..., :r], hits


def simulate_ttl_cache(
    generator: torch.Generator | None,
    lam: np.ndarray,
    ttl: np.ndarray,
    n_requests: int,
    *,
    draws: tuple[Tensor, Tensor] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Empirical per-file hit counts of the simulated cache.

    Generates a merged Poisson stream at ``lam`` (or takes ``draws``, the
    arrival times and file ids), replays it through :func:`ttl_cache_scan`
    from a cold start on ``device`` and returns host ``(hits, requests)``
    per file — the measurement the Che model is compared against.
    """
    from .simulator import _check_generator, generate_workload

    dev = _device(device)
    lam_t = torch.as_tensor(np.asarray(lam), dtype=torch.float32, device=dev)
    r = int(lam_t.shape[0])
    if draws is None:
        _check_generator(generator, dev)
        t, fid = generate_workload(generator, lam_t, n_requests)
    else:
        t, fid = draws
    _, hits = ttl_cache_scan(
        cold_cache(r, device=dev).expiry, t, fid,
        torch.as_tensor(np.asarray(ttl), dtype=torch.float32, device=dev),
    )
    fid_np = fid.cpu().numpy()
    n_hit = np.bincount(fid_np, weights=hits.cpu().numpy().astype(float), minlength=r)
    n_req = np.bincount(fid_np, minlength=r).astype(float)
    return n_hit, n_req
