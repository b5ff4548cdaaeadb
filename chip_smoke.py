#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Build the FCFS kernel from ``src/repro_torch/kernels/csrc/fcfs_queue.cu``
   with nvcc (into ``build/repro_torch/``); print the build seconds and the
   card's name and power limit.
2. Hold the kernel against its plain PyTorch twin on the card: random,
   heavily loaded inputs at (S, N, m) = (64, 2048, 12), (5, 128, 6) and
   (3, 256, 40) (the kernel's wide instance), and unbatched at (2048, 12),
   all through ``fcfs_scan``, with carried queue state and ~5% empty mask
   rows, must give bitwise-equal latency and dep, and busy within rtol 1e-6.
3. Quickstart twin: three files (k = 6, 7, 4) solved at theta = 0.5 and
   200, then simulated with 20000 requests; the simulated mean must stay
   within the bound x 1.05, the claim ``examples/quickstart.py`` asserts.
4. The paper's §V.B catalog (r = 1000 files, k = 6, 7, 6, 4 by quarter,
   aggregate ~0.118 req/s) on the 12-node testbed at theta = 2: the solve
   must descend monotonically and stop within 250 iterations (fig8's
   claims), and a fleet of 256 seeds x 100000 requests must go through the
   kernel with a finite mean latency within the bound x 1.05.

In phases 3 and 4 the launch count is set to 0 just before each simulator
call and read just after; each call must have launched the kernel. Every
scan those calls make is recorded, and its output is held against the
plain twin on the same masks and service times, as in phase 2. The kernel
and the plain twin are timed with CUDA events on the fleet's own inputs.

It then prints the kernel record as one JSON line and, last, the device
line. It needs a CUDA card, and fails without one.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import JLCMProblem, solve  # noqa: E402
from repro_torch.kernels import fcfs_queue  # noqa: E402
from repro_torch.kernels.fcfs_queue import (  # noqa: E402
    fcfs_scan,
    fcfs_scan_cuda,
    fcfs_scan_plain,
)
from repro_torch.storage import (  # noqa: E402
    GeoFabric,
    simulate,
    simulate_fleet,
    simulator,
    tahoe_testbed,
)

FLEET_SEEDS, FLEET_REQUESTS, NODES = 256, 100_000, 12
# NVIDIA's published H100 SXM peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def paper_catalog(r: int = 1000, file_mb: float = 150.0, device="cuda"):
    """The §V.B experiment: r files in four quarters with k = 6, 7, 6, 4
    (equal file sizes, so different chunk sizes), aggregate ~0.118 req/s.
    Returns float32 ``lam`` and ``k`` on ``device`` and the per-file chunk
    sizes as numpy."""
    ks = np.zeros(r, np.float32)
    ks[0::4], ks[1::4], ks[2::4], ks[3::4] = 6, 7, 6, 4
    lam = np.zeros(r, np.float32)
    lam[0::3] = 1.25 / 10000
    lam[1::3] = 1.25 / 10000
    lam[2::3] = 1.25 / 12000
    return (
        torch.tensor(lam, device=device),
        torch.tensor(ks, device=device),
        file_mb / ks,
    )


def random_fcfs_inputs(gen, lead, n, m, device):
    """Arrivals, masks with ~5% empty rows, service times, carried state.
    Each node sees half the requests at a mean service time of 1.7 unit
    gaps, so its queue runs at ~85% utilisation."""
    lead = tuple(lead)
    exp = lambda shape: torch.empty(shape, device=device).exponential_(generator=gen)
    t = torch.cumsum(exp(lead + (n,)), dim=-1)
    masks = torch.rand(lead + (n, m), generator=gen, device=device) < 0.5
    masks &= ~(torch.rand(lead + (n,), generator=gen, device=device) < 0.05)[..., None]
    service = 0.2 + 1.5 * exp(lead + (n, m))
    return t, masks, service, exp(lead + (m,)), exp(lead + (m,))


def check_parity(got: tuple, want: tuple, label: str) -> float:
    """Kernel vs plain twin: latency (-inf rows included) and dep bitwise,
    busy bitwise or within rtol 1e-6 (the bound tests/test_fleet_parity.py
    holds the reference's backends to). Returns the largest |difference|."""
    for name, x, y in zip(("latency", "dep"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{label} {name}: kernel != plain twin")
    if not torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0):
        raise AssertionError(f"{label} busy: kernel differs from plain twin")
    return float((got[2] - want[2]).abs().max())


def cuda_ms(fn, reps: int):
    """Mean milliseconds per call by CUDA events, and the last call's result."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


@contextlib.contextmanager
def recorded_scans():
    """Record every ``fcfs_scan`` call the simulator makes: its inputs and
    the outputs it got back, so that the kernel can be held against its
    plain twin on the main path's own masks and service times."""
    calls = []

    def recorder(*args):
        out = fcfs_scan(*args)
        calls.append((args, out))
        return out

    simulator.fcfs_scan = recorder
    try:
        yield calls
    finally:
        simulator.fcfs_scan = fcfs_scan


def counted(label: str, fn):
    """Run one main-path call with the launch count set to 0 just before
    it; return its result and the count read just after."""
    fcfs_scan.launches = 0
    out = fn()
    launches = fcfs_scan.launches
    if launches < 1:
        raise AssertionError(f"{label} did not go through the FCFS kernel")
    return out, launches


def hold_against_plain(calls, label: str, time_it: bool = False) -> dict:
    """Each recorded scan's output against the plain twin on its inputs;
    with ``time_it``, also time kernel and plain twin on the last one."""
    record = dict(max_abs_err=0.0)
    for args, got in calls:
        t, masks, service = args[:3]
        zeros = torch.zeros(t.shape[:-1] + service.shape[-1:], device=t.device)
        plain_ms, want = cuda_ms(
            lambda: fcfs_scan_plain(t, masks, service, zeros, zeros), reps=1)
        err = check_parity(got, want, f"{label} {tuple(service.shape)}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        print(f"[{label}] main-path scan {tuple(service.shape)}: kernel == plain "
              f"twin, busy max_abs_err {err}, plain twin {plain_ms:.1f} ms")
    if time_it:
        kernel_ms, _ = cuda_ms(
            lambda: fcfs_scan_cuda(t, masks, service, zeros, zeros), reps=5)
        record.update(ms=kernel_ms, plain_ms=plain_ms, **bound(*service.shape))
    return record


def bound(s: int, n: int, m: int) -> dict:
    """The least time for one scan: each input read once and each output
    written once, or its float32 operations at the card's peak rate."""
    n_bytes = s * n * (8 + 5 * m) + 16 * s * m
    n_ops = 6 * s * n * m  # max, add, 2 selects, busy add, reduction step
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_gb=n_bytes / 1e9,
    )


def phase_build() -> float:
    t0 = time.perf_counter()
    fcfs_queue.load_library()
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"[1] fcfs kernel built/loaded in {build_s:.3f} s")
    print(card)
    return build_s


def phase_kernel_vs_plain(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = 0.0
    for lead, n, m in [((64,), 2048, 12), ((5,), 128, 6), ((3,), 256, 40), ((), 2048, 12)]:
        t, masks, service, dep0, busy0 = random_fcfs_inputs(gen, lead, n, m, dev)
        got = fcfs_scan(t, masks, service, dep0, busy0)
        want = fcfs_scan_plain(t, masks, service, dep0, busy0)
        shape = tuple(service.shape)
        err = check_parity(got, want, str(shape))
        worst = max(worst, err)
        print(f"[2] {shape} kernel == plain twin, busy max_abs_err {err} "
              f"({int(torch.isneginf(got[0]).sum())} empty service sets, "
              f"mean latency {float(got[0][torch.isfinite(got[0])].mean()):.2f})")
    return worst


def phase_quickstart(dev) -> tuple[int, float]:
    cluster = tahoe_testbed(device=dev)
    ks = torch.tensor([6.0, 7.0, 4.0], device=dev)
    lam = torch.full((3,), 0.125 / 3, device=dev)
    chunk_mb = float(np.mean(200.0 / np.array([6.0, 7.0, 4.0])))
    launches, worst = 0, 0.0
    for theta in (0.5, 200.0):
        prob = JLCMProblem(lam=lam, k=ks, moments=cluster.moments(chunk_mb),
                           cost=cluster.cost, theta=theta)
        t0 = time.perf_counter()
        sol = solve(prob, max_iters=300)
        solve_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(0)
        with recorded_scans() as calls:
            sim, n = counted("simulate", lambda: simulate(
                gen, sol.pi, lam, cluster, chunk_mb, 20000))
        launches += n
        mean, bound = float(sim.mean_latency()), float(sol.latency_tight)
        print(f"[3] theta={theta}: n_i={sol.n.tolist()} cost={float(sol.cost):.2f} "
              f"bound={bound:.3f}s simulated={mean:.3f}s "
              f"iterations={int(sol.iterations)} solve={solve_s:.2f}s fcfs launches {n}")
        if not mean <= bound * 1.05:
            raise AssertionError(f"theta={theta}: simulated {mean} > bound {bound} x 1.05")
        worst = max(worst, hold_against_plain(calls, "3")["max_abs_err"])
    return launches, worst


def phase_catalog(dev) -> tuple[int, dict]:
    cluster = tahoe_testbed(device=dev)
    lam, ks, chunk = paper_catalog(1000, device=dev)
    eff_chunk = float(np.average(chunk, weights=lam.cpu().numpy()))
    prob = JLCMProblem(lam=lam, k=ks, moments=cluster.moments(eff_chunk),
                       cost=cluster.cost, theta=2.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve(prob, eps=0.01, max_iters=300)
    trace = sol.objective_trace.cpu().numpy()
    solve_s = time.perf_counter() - t0
    iters = len(trace) - 1
    bound = float(sol.latency_tight)
    n_i = sol.n.cpu().numpy()
    print(f"[4] r=1000 solve: {iters} iterations in {solve_s:.3f} s, "
          f"bound={bound:.3f}s cost={float(sol.cost):.1f} "
          f"mean n_i by quarter k=6,7,6,4: {[float(n_i[q::4].mean()) for q in range(4)]}")
    if not (np.diff(trace) <= 1e-2).all():
        raise AssertionError(f"objective trace rises: {trace}")
    if iters > 250:
        raise AssertionError(f"solve took {iters} > 250 iterations")

    fabric = GeoFabric.single_site(cluster)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_scans() as calls:
        fleet, launches = counted("simulate_fleet", lambda: simulate_fleet(
            gen, sol.pi, lam[None], fabric, eff_chunk, FLEET_REQUESTS, FLEET_SEEDS))
        mean = float(fleet.mean_latency())
    fleet_s = time.perf_counter() - t0
    warm = FLEET_REQUESTS // 10
    if fleet.latency.shape != (FLEET_SEEDS, FLEET_REQUESTS - warm):
        raise AssertionError(f"fleet latency shape {tuple(fleet.latency.shape)}")
    if not bool(torch.isfinite(fleet.latency).all()):
        raise AssertionError("fleet latencies are not all finite")
    if not mean <= bound * 1.05:
        raise AssertionError(f"fleet mean {mean} > bound {bound} x 1.05")
    per_seed = fleet.latency.mean(dim=1)
    print(f"[4] fleet {FLEET_SEEDS} seeds x {FLEET_REQUESTS} requests: "
          f"mean={mean:.3f}s (per-seed {float(per_seed.min()):.2f}.."
          f"{float(per_seed.max()):.2f}) bound={bound:.3f}s, "
          f"wall {fleet_s:.3f} s, {FLEET_SEEDS * FLEET_REQUESTS / fleet_s:.4g} req/s, "
          f"fcfs launches {launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    record = hold_against_plain(calls, "4", time_it=True)
    print(f"[4] {tuple(calls[-1][0][2].shape)} on the fleet's inputs: kernel "
          f"{record['ms']:.3f} ms, plain twin {record['plain_ms']:.1f} ms, bound "
          f"{record['bound_ms']:.3f} ms ({record['bound_gb']:.3f} GB)")
    return launches, record


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # keep output if the run is cut
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    worst = phase_kernel_vs_plain(dev)
    quick_launches, quick_err = phase_quickstart(dev)
    fleet_launches, record = phase_catalog(dev)
    print(json.dumps({"kernels": [{
        "name": "fcfs_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fcfs_queue.cu",
        "replaces": "src/repro/kernels/fcfs_queue.py:108",
        "parity": "bitwise",
        "launches": quick_launches + fleet_launches,
        "launches_by_path": {"quickstart_simulate": quick_launches,
                             "catalog_simulate_fleet": fleet_launches},
        "max_abs_err": max(worst, quick_err, record["max_abs_err"]),
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
