"""The `checks` driver: back-to-back fleet simulations of the set-up's plan.

An operator checks a plan by simulating it: one check is `seeds`
independent systems of `requests` reads each, through `simulate_fleet`
(Madow sets, service times, kernel B1), and reads the mean back. Each
check's draws come from a generator of its own, made on the device by the
harness: arrivals of the catalog's merged Poisson stream, file marks by
rate, one Madow uniform per read and one unit exponential per node. Every
uniform is kept at least `margin` from its file's segment boundaries, so
that the reference, summing the plan in another order, picks the same
nodes (it moves one uniform in about 10^4 by 3 x 10^-5).
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from repro_torch.storage.cluster import GeoFabric
from repro_torch.storage.simulator import SimDraws

from perfbench.reference import checks as ref_checks
from perfbench.reference import fcfs as ref_fcfs

from . import deploy, roofline
from .common import clock, generator, host_rng, sync
from .system import System

KERNEL = "fcfs_queue"  # the kernel library the window drives (B1)


@dataclasses.dataclass
class State:
    cell: object
    dep: deploy.Deployment
    system: object
    spans: object
    seed: int
    seconds: float
    fabric: GeoFabric
    lam_cs: torch.Tensor
    cdf: torch.Tensor
    seeds: int
    requests: int
    margin: float
    keep: set
    bounds: torch.Tensor  # (r, m) each file's segment ends, summed once at set-up
    kept: dict = dataclasses.field(default_factory=dict)
    checks: int = 0
    near_boundary: int = 0
    last: tuple | None = None  # (index, latency) of the last check


def setup(cell, seed, seconds, device, spans, system, parts) -> State:
    traffic = cell.traffic
    dep = deploy.build(cell.config, device, parts)
    lam = torch.as_tensor(dep.lam, device=device)
    g = host_rng(seed, "sample-checks")
    # checks 1.. so that a check returning its predecessor's result shows
    keep = set(int(j) for j in g.choice(np.arange(1, int(traffic["sample_from"])),
                                        int(traffic["sample_checks"]), replace=False))
    st = State(cell=cell, dep=dep, system=system, spans=spans, seed=seed, seconds=seconds,
               fabric=GeoFabric.single_site(dep.cluster), lam_cs=lam[None],
               cdf=torch.cumsum(lam / lam.sum(), 0), seeds=int(traffic["seeds"]),
               requests=int(traffic["requests"]), margin=float(traffic["margin"]), keep=keep,
               bounds=torch.cumsum(dep.solution.pi, dim=-1))
    start = clock()
    _one_check(st, draws(st, "warm"))
    sync(device)
    parts["warm_s"] = clock() - start
    return st


def draws(st: State, *tag) -> SimDraws:
    dev, s, n, m = st.dep.device, st.seeds, st.requests, st.dep.m
    g = generator(dev, st.seed, "check", *tag)
    gaps = torch.empty((s, n), device=dev).exponential_(generator=g)
    arrival = torch.cumsum(gaps, -1) / st.lam_cs.sum()
    marks = torch.rand((s, n), generator=g, device=dev)
    file_id = torch.searchsorted(st.cdf, marks, right=True).clamp_(0, st.cdf.shape[0] - 1)
    u = torch.rand((s, n), generator=g, device=dev)
    exp = torch.empty((s, n, m), device=dev).exponential_(generator=g)
    return SimDraws(arrival, file_id, _off_boundaries(st, u, file_id), exp,
                    torch.zeros((s, n), dtype=torch.int64, device=dev))


def _off_boundaries(st: State, u: torch.Tensor, file_id: torch.Tensor) -> torch.Tensor:
    """Move each uniform that lies within ``margin`` of one of its file's
    segment boundaries (0, pi_0, pi_0 + pi_1, ...) by 3 x margin, twice."""
    for _ in range(2):
        blocks = []
        for lo in range(0, u.shape[0], 32):
            uu = u[lo:lo + 32]
            x = st.bounds[file_id[lo:lo + 32]] - uu[..., None]
            near = ((x - torch.round(x)).abs() < st.margin).any(-1)
            near |= (uu < st.margin) | (uu > 1.0 - st.margin)
            blocks.append(torch.where(near, torch.remainder(uu + 3 * st.margin, 1.0), uu))
        u = torch.cat(blocks)
    return u


def _one_check(st: State, d: SimDraws):
    sp = st.spans
    with sp("simulate_fleet"):
        res = st.system.simulate(None, st.dep.solution.pi, st.lam_cs, st.fabric,
                                 st.dep.service_chunk_mb, st.requests, st.seeds,
                                 drop_warmup=0.0, devices="never", draws=d)
    with sp("collect"):
        warm = int(st.requests * float(st.cell.traffic["warmup_share"]))
        float(res.latency[:, warm:].mean())  # the operator reads the mean
    return res


def window(st: State) -> dict:
    sp = st.spans
    with sp("window"):
        t0 = clock()
        while clock() - t0 < st.seconds:
            with sp("draws"):
                d = draws(st, st.checks)
            res = _one_check(st, d)
            if st.checks in st.keep:
                st.kept[st.checks] = res.latency
            st.last = (st.checks, res.latency)
            st.checks += 1
        elapsed = clock() - t0
    simulated = st.checks * st.seeds * st.requests
    return dict(
        values=dict(sim_Mreq_per_s=simulated / elapsed / 1e6),
        attempted=st.checks, failed=0,
        counters=dict(checks=st.checks,
                      b1_bytes=st.checks * roofline.fcfs_scan_bytes(st.seeds, st.requests,
                                                                    st.dep.m)),
        info=dict(checks=st.checks, elapsed_s=elapsed,
                  check_ms=elapsed / max(st.checks, 1) * 1e3),
    )


def check(st: State) -> dict:
    """Sampled seeds of sampled checks walked again by the reference."""
    dep = st.dep
    compared = dict(plan_violations=ref_checks.plan_violations(dep.pi, dep.k, dep.plan.n,
                                                               dep.plan.placement, dep.mask))
    if st.last is not None and any(j not in st.kept for j in st.keep):
        st.kept.setdefault(*st.last)  # a sampled check not reached: the last one
    rows = np.sort(host_rng(st.seed, "sample-seeds").choice(
        st.seeds, min(int(st.cell.traffic["sample_seeds"]), st.seeds), replace=False))
    nodes = deploy.nodes(dep.config)
    overhead = np.array([n["overhead_s"] for n in nodes], np.float32)
    bandwidth = np.array([n["bandwidth_mbps"] for n in nodes], np.float32)
    got, t, masks, service, near = [], [], [], [], 0
    for j in sorted(st.kept):
        got.append(st.kept.pop(j)[rows].cpu().numpy())
        d = draws(st, j)
        tt, ff, uu, ee = (x[rows].cpu().numpy() for x in (d.arrival, d.file_id, d.u, d.exp))
        del d
        pi_rows = dep.pi[ff]
        near += int(ref_fcfs.near_boundary(uu, pi_rows, st.margin / 2).sum())
        t.append(tt)
        masks.append(ref_fcfs.madow(uu, pi_rows))
        service.append(ref_fcfs.service_times(ee, overhead, bandwidth, dep.service_chunk_mb))
    if got:
        want = ref_fcfs.walk(np.concatenate(t), np.concatenate(masks),
                             np.concatenate(service)).numpy()
        mismatches = int((np.concatenate(got) != want).sum())
    else:
        mismatches = 1  # nothing came back to compare
    st.near_boundary = near  # the harness's own margin, reported beside the check
    compared["lat_mismatches"] = mismatches
    return {name: (value, 0) for name, value in compared.items()}


def _control_simulate(generator, pi, lam_cs, fabric, chunk_mb, n_requests, n_seeds, *,
                      draws, **_):
    d, rate = (x[0].cpu() for x in fabric.service_params(chunk_mb))
    pi_rows = pi.cpu().numpy()[draws.file_id.cpu().numpy()]
    masks = ref_fcfs.madow(draws.u.cpu().numpy(), pi_rows)
    service = (d.to(torch.bfloat16) + draws.exp.cpu().to(torch.bfloat16)
               / rate.to(torch.bfloat16))
    latency = ref_fcfs.walk(draws.arrival.cpu().float().numpy(), masks,
                            service.float().numpy(), dtype=torch.bfloat16)
    return types.SimpleNamespace(latency=latency.float().to(pi.device))


def control() -> System:
    """The reference's FCFS walk in bfloat16, below the stated float32."""
    return System(simulate=_control_simulate)


class _SimulateUnchanged:
    """Returns the first check's result for every later check."""

    def __init__(self):
        self.last = None

    def __call__(self, *args, **kwargs):
        if self.last is None:
            self.last = System().simulate(*args, **kwargs)
        return self.last


def _simulate_half(generator, pi, lam_cs, fabric, chunk_mb, n_requests, n_seeds, *, draws,
                   **kwargs):
    h = n_seeds // 2
    half = type(draws)(*(None if x is None else x[:h] for x in draws))
    res = System().simulate(generator, pi, lam_cs, fabric, chunk_mb, n_requests, h,
                            draws=half, **kwargs)
    rest = torch.zeros((n_seeds - h,) + tuple(res.latency.shape[1:]), device=pi.device)
    return res._replace(latency=torch.cat([res.latency, rest]))


def _simulate_altered(*args, **kwargs):
    res = System().simulate(*args, **kwargs)
    res.latency[0, 0] += 1.0
    return res


def fault(name: str) -> System:
    """The fleet simulation with one of `system.FAULTS` planted."""
    simulate = dict(unchanged=_SimulateUnchanged, half_batch=lambda: _simulate_half,
                    altered=lambda: _simulate_altered)[name]()
    return System(simulate=simulate)
