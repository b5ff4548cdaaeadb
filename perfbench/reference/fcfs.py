"""Probabilistic scheduling and the FCFS queues, as plainly as they are stated.

Madow's systematic sampling (paper §III.A): lay the file's pi_j end to end
on [0, k) and take the nodes whose segment holds one of u, u + 1, ...,
u + k - 1. Each node serves its chunk requests first come, first served:

    start  = max(t, dep_j);  finish = start + service_j;  dep_j = finish
    latency = max over the request's nodes of finish - t

Madow here sums pi left to right in float32 (NumPy's `cumsum`); the harness
keeps every u at least `MARGIN` from a segment boundary, so any order of
summation picks the same nodes. The walk runs in PyTorch on the host in the
dtype it is given: float32 is the stated precision, bfloat16 the control.
"""
from __future__ import annotations

import numpy as np
import torch

MARGIN = 1e-5  # the harness's least distance between a u and a boundary


def boundaries(pi_rows: np.ndarray) -> np.ndarray:
    """(..., m + 1) segment boundaries 0, pi_0, pi_0 + pi_1, ... in float32."""
    pi_rows = np.asarray(pi_rows, dtype=np.float32)
    zero = np.zeros(pi_rows.shape[:-1] + (1,), np.float32)
    return np.concatenate([zero, np.cumsum(pi_rows, axis=-1, dtype=np.float32)], axis=-1)


def madow(u: np.ndarray, pi_rows: np.ndarray) -> np.ndarray:
    """(..., m) bool: node j is read iff its segment holds a grid point."""
    c = boundaries(pi_rows)
    shifted = np.floor(c - np.asarray(u, np.float32)[..., None])
    return (shifted[..., 1:] - shifted[..., :-1]) >= 1.0


def near_boundary(u: np.ndarray, pi_rows: np.ndarray, margin: float = MARGIN) -> np.ndarray:
    """(...) bool: a boundary lies within ``margin`` of a grid point."""
    x = boundaries(pi_rows).astype(np.float64) - np.asarray(u, np.float64)[..., None]
    return (np.abs(x - np.round(x)) < margin).any(axis=-1)


def walk(t, masks, service, dtype=torch.float32) -> torch.Tensor:
    """(R, N) latencies of R independent systems from idle queues.

    ``t`` (R, N) arrivals, ``masks`` (R, N, m) bool, ``service`` (R, N, m);
    a request with no node gets -inf.
    """
    t = torch.as_tensor(np.asarray(t), dtype=dtype)
    masks = torch.as_tensor(np.asarray(masks), dtype=torch.bool)
    service = torch.as_tensor(np.asarray(service), dtype=dtype)
    dep = torch.zeros(service.shape[0], service.shape[2], dtype=dtype)
    out = torch.empty(t.shape, dtype=dtype)
    neg = torch.tensor(-float("inf"), dtype=dtype)
    for i in range(t.shape[1]):
        ti = t[:, i, None]
        finish = torch.maximum(ti, dep) + service[:, i]
        dep = torch.where(masks[:, i], finish, dep)
        out[:, i] = torch.where(masks[:, i], finish, neg).amax(dim=-1) - t[:, i]
    return out


def service_times(exp: np.ndarray, overhead: np.ndarray, bandwidth: np.ndarray,
                  chunk_mb: float) -> np.ndarray:
    """Shifted exponential service D_j + Exp / (bw_j / B), in float32."""
    rate = np.asarray(bandwidth, np.float32) / np.float32(chunk_mb)
    return np.asarray(overhead, np.float32) + np.asarray(exp, np.float32) / rate
