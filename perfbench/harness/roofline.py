"""Peaks of the card and the bytes each measured operation needs.

A roofline share is the least time the card could take for the work, the
bytes it needs at the peak HBM rate, over the device time it took. Bytes
count each input read once and each output written once, from the shapes
the harness hands over, so a later change that fuses or replaces a kernel is
measured against the same work. The kernel formulas are those of
`chip_smoke.py` (`bound`, `gf_bound`); the operation counts there stay
below the bytes on every shape these cells run, so the bytes bind.
"""
from __future__ import annotations

# Published peaks of the SXM part at its 700 W limit (NVIDIA's data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_kind: str) -> float | None:
    """The card's peak HBM rate, or None for a card not in the table."""
    peak = PEAKS.get(device_kind)
    return None if peak is None else peak["hbm_bytes_per_s"]


def fcfs_scan_bytes(s: int, n: int, m: int) -> int:
    """Kernel B1 on (S, N, m): arrivals, masks and service read, latencies
    written, carried dep and busy read and written."""
    return s * n * (8 + 5 * m) + 16 * s * m


def gf256_bytes(batch: int, m: int, k: int, n: int) -> int:
    """Kernels B2 / B3: (batch, M, K) x (batch, K, N) -> (batch, M, N) uint8."""
    return batch * (m * k + k * n + m * n)


def decode_bytes(k: int, row_bytes: int) -> int:
    """A degraded read's decode: k chunk rows read, k data rows written."""
    return 2 * k * row_bytes


def encode_bytes(n: int, k: int, row_bytes: int) -> int:
    """A block group's encode: k data rows read, n coded rows written."""
    return (k + n) * row_bytes


def share(need_bytes: float, seconds: float, device_kind: str) -> float | None:
    """Percent of the roofline: bytes at the peak rate over the time taken;
    None where nothing was measured or the card has no peak in the table."""
    peak = hbm_bytes_per_s(device_kind)
    if peak is None or not need_bytes or not seconds or seconds <= 0:
        return None
    return 100.0 * need_bytes / peak / seconds
