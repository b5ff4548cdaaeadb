"""Seeds, clocks and payloads shared by the drivers and the reference check.

Every random input of a run is drawn from ``--seed`` through :func:`derive`,
which mixes the seed with a tag naming what is drawn, so the same seed gives
the same inputs and two purposes never share a stream. Seeds may exceed 64
bits' signed range only up to what ``derive`` hashes, which is any integer.
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from collections import defaultdict

import numpy as np
import torch
from torch import Tensor

clock = time.perf_counter


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device: torch.device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def host_rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fill_payload(out: Tensor, seed: int, *tags) -> Tensor:
    """Fill ``out`` (uint8, contiguous) with the bytes named by ``tags``,
    on its own device, from one generator: the same call regenerates them."""
    return out.random_(0, 256, generator=generator(out.device, seed, *tags))


def payload(shape, device, seed: int, *tags) -> Tensor:
    return fill_payload(torch.empty(shape, dtype=torch.uint8, device=device), seed, *tags)


class Spans:
    """The harness's spans around its calls into each layer.

    Host durations are kept for every span; with ``annotate`` each span is
    also a ``torch.profiler.record_function`` range, so the traced run can
    put device time and idle gaps under it.
    """

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.durations: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = clock()
        if self.annotate:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.durations[name].append(clock() - start)


def percentile(values: np.ndarray, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` of
    the sample at or below it."""
    ordered = np.sort(np.asarray(values, dtype=np.float64))
    rank = max(int(np.ceil(q * ordered.size)) - 1, 0)
    return float(ordered[rank])
