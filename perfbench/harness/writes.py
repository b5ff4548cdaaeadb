"""The `writes` driver: a closed loop of writers storing coded block groups.

Each of `writers` clients writes one block group (k rows of the
configuration's block size) and waits for its acknowledgement before its
next. A step takes every pending write as one `encode_batch(..., n)` and
acknowledges them when the n coded rows are complete on the device. The
store is a ring of the configuration's resident count of block groups: it
keeps the returned rows and frees the oldest; set-up fills it, as a store
in use is full, so the window maps no new device memory. Payloads come
from a pool of `pool_block_groups` groups made from the seed at set-up;
step j (counted from set-up's first) writes the `writers` groups that
start at pool entry j mod (pool - writers + 1), so consecutive steps write
different bytes and the data is a view, never a copy.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import torch

from perfbench.reference import gf256 as ref_gf

from . import roofline
from .common import clock, host_rng, payload, sync
from .system import System

KERNEL = "gf256_matmul"  # the kernel library the window drives (B2)


@dataclasses.dataclass
class State:
    cell: object
    device: torch.device
    system: object
    spans: object
    seed: int
    seconds: float
    n: int
    k: int
    width: int
    writers: int
    slots: int
    pool: torch.Tensor  # (P, k, L)
    ring: deque = dataclasses.field(default_factory=deque)
    steps: int = 0


def setup(cell, seed, seconds, device, spans, system, parts) -> State:
    config, traffic = cell.config, cell.traffic
    n, k = int(config["code"]["n"]), int(config["code"]["k"])
    width = int(config["catalog"]["file_bytes"]) // k
    start = clock()
    pool = torch.empty((int(traffic["pool_block_groups"]), k, width), dtype=torch.uint8,
                       device=device)
    for p in range(pool.shape[0]):
        pool[p] = payload((k, width), device, seed, "pool", p)
    sync(device)
    parts["pool_s"] = clock() - start
    st = State(cell=cell, device=device, system=system, spans=spans, seed=seed,
               seconds=seconds, n=n, k=k, width=width, writers=int(traffic["writers"]),
               slots=int(config["resident"]), pool=pool)
    start = clock()
    for _ in range(st.slots // st.writers + 1):  # the window's one shape, the ring full
        _step(st)
    parts["warm_s"] = clock() - start
    return st


def _first(st: State, step: int) -> int:
    return step % (st.pool.shape[0] - st.writers + 1)


def _step(st: State) -> None:
    """Free the oldest groups, encode the pending writes, acknowledge them."""
    sp, w = st.spans, st.writers
    with sp("store"):
        while len(st.ring) > st.slots - w:
            st.ring.popleft()
    first = _first(st, st.steps)
    with sp("encode_batch"):
        out = st.system.encode(st.pool[first:first + w], st.n)
    with sp("ack"):
        sync(st.device)
    for i in range(w):
        st.ring.append((st.steps, first + i, out[i] if i < out.shape[0] else None))
    st.steps += 1


def window(st: State) -> dict:
    steps = 0
    with st.spans("window"):
        t0 = clock()
        while clock() - t0 < st.seconds:
            _step(st)
            steps += 1
        elapsed = clock() - t0
    acked = steps * st.writers
    user = acked * st.k * st.width
    return dict(
        values=dict(write_GBps=user / elapsed / 1e9),
        attempted=acked, failed=0,
        counters=dict(steps=steps, writes=acked,
                      encode_bytes=acked * roofline.encode_bytes(st.n, st.k, st.width),
                      b2_bytes=steps * roofline.gf256_bytes(1, st.n - st.k, st.k,
                                                             st.writers * st.width)),
        info=dict(steps=steps, writes=acked, elapsed_s=elapsed,
                  step_ms=elapsed / max(steps, 1) * 1e3),
    )


def check(st: State) -> dict:
    """Acknowledged writes read back from the ring against the stated code."""
    picks = host_rng(st.seed, "sample-writes").choice(
        len(st.ring), min(int(st.cell.traffic["sample_writes"]), len(st.ring)), replace=False)
    kept = [(p, None if got is None else got.clone())
            for i, (_, p, got) in enumerate(st.ring) if i in set(picks.tolist())]
    st.ring.clear()
    st.pool = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    bad = 0
    for p, got in kept:
        want = ref_gf.encode(payload((st.k, st.width), st.device, st.seed, "pool", p), st.n)
        bad += got is None or tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want)
    # a window that stored nothing has nothing right to show
    return dict(bad_stored_groups=(int(bad) + (not kept), 0))


def _control_encode(data, n):
    return torch.stack([ref_gf.xor_parity(d, n) for d in data])


def control() -> System:
    """The reference's encode with parity as the XOR of the data rows: a
    code that survives one lost row where RS(n, k) survives n - k."""
    return System(encode=_control_encode)


def _encode_unchanged(data, n):
    return data


def _encode_half(data, n):
    h = data.shape[0] // 2
    rest = torch.zeros((data.shape[0] - h, n, data.shape[2]), dtype=data.dtype,
                       device=data.device)
    return torch.cat([System().encode(data[:h], n), rest]) if h else rest


def _encode_altered(data, n):
    out = System().encode(data, n)
    out[0, -1, 0] ^= 1
    return out


def fault(name: str) -> System:
    """The encode with one of `system.FAULTS` planted."""
    encode = dict(unchanged=_encode_unchanged, half_batch=_encode_half,
                  altered=_encode_altered)[name]
    return System(encode=encode)
