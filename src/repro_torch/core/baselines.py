"""Prior-work latency baselines used in the paper's comparisons (Fig. 7).

[43] Joshi, Liu, Soljanin, "On the Delay-Storage Trade-off in Content
Download from Coded Distributed Storage Systems": single file, (n, k)
fork-join queue, exponential service. Their upper bound is the
*split-merge* relaxation: all n servers stay blocked until the k-th chunk
completes, so the system is an M/G/1 queue whose service time is the k-th
order statistic of n iid Exp(mu):

    E[S] = (H_n - H_{n-k})/mu,   Var[S] = (H2_n - H2_{n-k})/mu^2

with H2 the generalized harmonic numbers of order 2. P-K then gives the
mean sojourn bound. It holds only for lam * E[S] < 1; beyond that the
bound is +inf (the regime where the paper's Fig. 7 shows its own bound
stays finite).

Both functions run where their tensor arguments live (the CPU for plain
numbers) in float32, on the reference's float32 harmonic tables (nmax
4096), summed in the reference's order (:func:`_scan_cumsum`), so the
harmonic sums agree with it bit for bit.
"""
from __future__ import annotations

import functools

import torch
from torch import Tensor


def _device_of(*xs) -> torch.device:
    return next((x.device for x in xs if isinstance(x, Tensor)), torch.device("cpu"))


def _scan_cumsum(x: Tensor, block: int = 16) -> Tensor:
    """Prefix sums of a 1-D float32 tensor in the order the reference's
    ``jnp.cumsum`` takes on the CPU (XLA's rewrite of the cumulative
    reduce-window): each block of 16 is summed one element at a time, and
    each block's offset, the prefix sum of the block totals before it, is
    taken the same way and added. ``torch.cumsum`` accumulates float32 in
    float64 on the CPU, so it rounds elsewhere."""
    n = x.shape[0]
    n_blocks = -(-n // block)
    xb = torch.cat([x, x.new_zeros(n_blocks * block - n)]).view(n_blocks, block)
    cols = [xb[:, 0]]
    for j in range(1, block):
        cols.append(cols[-1] + xb[:, j])
    local = torch.stack(cols, dim=1)
    if n_blocks > 1:
        totals = _scan_cumsum(local[:, -1].contiguous(), block)
        local = local + torch.cat([x.new_zeros(1), totals[:-1]])[:, None]
    return local.reshape(-1)[:n]


@functools.cache
def _harmonic_table(order: int, nmax: int) -> Tensor:
    """(nmax + 1,) float32 host table: entry i is sum_{j <= i} 1/j^order."""
    terms = 1.0 / torch.arange(1, nmax + 1, dtype=torch.float32) ** order
    return torch.cat([torch.zeros(1), _scan_cumsum(terms)])


def _harmonic_range(lo: Tensor, hi: Tensor, order: int, nmax: int = 4096) -> Tensor:
    """sum_{i=lo+1}^{hi} 1/i^order, elementwise (lo, hi integer tensors)."""
    csum = _harmonic_table(order, nmax).to(lo.device)
    return csum[hi.long()] - csum[lo.long()]


def split_merge_bound(n, k, mu, lam) -> Tensor:
    """Fork-join upper bound of [43] (split-merge M/G/1), single file.

    Returns mean file latency; +inf where the split-merge queue is unstable.
    """
    dev = _device_of(n, k, mu, lam)
    n = torch.as_tensor(n, dtype=torch.int32, device=dev)
    k = torch.as_tensor(k, dtype=torch.int32, device=dev)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    mean_s = _harmonic_range(n - k, n, 1) / mu
    var_s = _harmonic_range(n - k, n, 2) / mu**2
    m2_s = var_s + mean_s**2
    rho = lam * mean_s
    wait = lam * m2_s / (2.0 * (1.0 - rho))
    t = mean_s + wait
    return torch.where(rho < 1.0, t, torch.inf)


def fork_join_exact_nn(n, mu, lam) -> Tensor:
    """Nelson-Tantawi-style approximation of the (n, n) fork-join with
    exponential service, ``H_n / (mu - lam)``: for sanity checks of
    orderings only, not used by the figures. +inf where lam >= mu."""
    dev = _device_of(n, mu, lam)
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    h_n = _harmonic_table(1, 63).to(dev)[n.long()]
    rho = lam / mu
    t_mm1 = 1.0 / (mu - lam)
    return torch.where(rho < 1.0, h_n * t_mm1, torch.inf)
