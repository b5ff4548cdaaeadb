"""The `reads` driver: open-loop reads of whole files with nodes down.

Set-up codes the configuration's resident files once and draws the run's
reads from the seed: a fixed count (rate x seconds) at uniform times over
the window (a Poisson stream given its count), files by the catalog's read
rates, one Madow uniform and one spare priority per node each. The window
serves, as one batch, every read that is due whenever the loop is free
(at most `max_batch_bytes` of reads):

1. `dispatch`: `dispatch_masks` with the availability mask, the sets to the
   host;
2. `fetch`: each set's chunk rows (`CodecPlan.chunk_nodes`' layout), the
   k stored rows of each read copied into one buffer a code, a device
   copy a row (the bytes a reader fetches from k nodes);
3. `decode_requests`: `CodecPlan.decode_requests`;
4. `wait`: the device done, the batch's reads complete.

A read is timed from when it was due to when its decoded rows are complete
on the device. Reads due in the window are all served, those still queued
at its close too (up to `drain_limit_s` past it); a read that never
completes counts as missing, slower than any other.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench.reference import checks as ref_checks
from perfbench.reference import fcfs as ref_fcfs
from perfbench.reference import gf256 as ref_gf

from . import deploy, roofline
from .common import clock, host_rng, payload, percentile, sync
from .system import System, decode_requests

KERNEL = "gf256_matmul"  # the kernel library the window drives (B3)


@dataclasses.dataclass
class Schedule:
    t: np.ndarray  # (N,) due times, seconds from the window's start
    files: np.ndarray  # (N,) file ids
    u: torch.Tensor  # (N,) Madow uniforms, on the device
    prio: torch.Tensor  # (N, m) spare priorities, on the device
    files_dev: torch.Tensor  # (N,) int64, on the device


def make_schedule(dep, seed: int, rate: float, seconds: float) -> Schedule:
    g = host_rng(seed, "reads")
    count = max(1, int(round(rate * seconds)))
    t = np.sort(g.random(count) * seconds)
    pop = dep.lam[dep.resident].astype(np.float64)
    files = g.choice(dep.resident, size=count, p=pop / pop.sum())
    u = g.random(count, dtype=np.float32)
    prio = g.random((count, dep.m), dtype=np.float32)
    dev = dep.device
    return Schedule(t=t, files=files, u=torch.as_tensor(u, device=dev),
                    prio=torch.as_tensor(prio, device=dev),
                    files_dev=torch.as_tensor(files, device=dev))


@dataclasses.dataclass
class State:
    cell: object
    dep: deploy.Deployment
    store: deploy.Store | None
    flat: dict  # code -> (files * n, L) view of the store
    system: object
    spans: object
    seed: int
    seconds: float
    rate: float
    alive: np.ndarray  # (m,) bool
    avail: torch.Tensor  # (m,) bool, on the device
    row_of: np.ndarray  # (r, m) chunk row of each file on each node, -1 if none
    pi: torch.Tensor
    max_batch: int
    sched: Schedule | None = None
    sample: np.ndarray | None = None
    acc: dict | None = None


def knee_rate(cell) -> float:
    """The offered rate: a share of the knee that the traffic file records
    for its configuration's reads."""
    return cell.traffic["rate_share_of_knee"] * cell.traffic["knee_reads_per_s"]


def setup(cell, seed, seconds, device, spans, system, parts, rate=None) -> State:
    dep = deploy.build(cell.config, device, parts)
    start = clock()
    store = deploy.build_store(dep, seed, system.encode)
    sync(device)
    parts["store_s"] = clock() - start
    parts["store_bytes"] = store.nbytes()
    alive = np.ones(dep.m, bool)
    alive[cell.traffic["failed_nodes"]] = False
    row_of = np.full((dep.k.shape[0], dep.m), -1, np.int64)
    for f in dep.resident:
        row_of[f, dep.plan.chunk_nodes(int(f))] = np.arange(int(dep.plan.n[f]))
    file_bytes = int(dep.k.max() * dep.row_bytes.max())
    st = State(cell=cell, dep=dep, store=store,
               flat={key: t.view(-1, t.shape[-1]) for key, t in store.tensors.items()},
               system=system, spans=spans, seed=seed, seconds=seconds,
               rate=knee_rate(cell) if rate is None else rate, alive=alive,
               avail=torch.as_tensor(alive, device=device), row_of=row_of,
               pi=dep.solution.pi,
               max_batch=max(1, int(cell.traffic["max_batch_bytes"]) // file_bytes))
    start = clock()
    warm(st)
    parts["warm_s"] = clock() - start
    plan_schedule(st, st.rate)
    return st


def warm(st: State) -> None:
    """Fill the decode-matrix cache with every pattern the live rows allow
    (through `decode_requests` on narrow rows), then serve the largest batch
    and a single read at full size, so the window allocates and builds
    nothing new."""
    dep = st.dep
    for (n, k), files in deploy.groups(dep, dep.resident).items():
        live = set()
        for f in files:
            live.update(int(c) for c, node in enumerate(dep.plan.chunk_nodes(int(f)))
                        if st.alive[node])
        pats = deploy.patterns(n, k, live)
        if pats:
            narrow = torch.zeros((len(pats), k, 16), dtype=torch.uint8, device=dep.device)
            st.system.decode(dep.plan, [int(files[0])] * len(pats), pats, list(narrow))
    for count in (st.max_batch, 1):
        st.sched = make_schedule(dep, st.seed + 1, count, 1.0)
        st.acc = _accumulators(len(st.sched.t))
        st.sample = np.zeros(0, np.int64)
        _serve(st, 0, len(st.sched.t), 0.0)
    sync(dep.device)


def plan_schedule(st: State, rate: float) -> None:
    st.rate = rate
    st.sched = make_schedule(st.dep, st.seed, rate, st.seconds)
    st.sample = sample_reads(st)
    st.acc = _accumulators(len(st.sched.t))
    # the sampled reads' copies, allocated now so the window's allocations
    # find the store's neighbourhood as the warm-up left it
    for idx in st.sample:
        f = int(st.sched.files[idx])
        st.acc["kept"][int(idx)] = torch.empty((int(st.dep.k[f]), int(st.dep.row_bytes[f])),
                                               dtype=torch.uint8, device=st.dep.device)


def sample_reads(st: State) -> np.ndarray:
    """The reads whose decoded rows are compared, drawn from the seed:
    `sample_reads_per_code` of each (n, k) code first, so that every code's
    decode is judged in every run, then the rest of `sample_reads` from all."""
    traffic, files = st.cell.traffic, st.sched.files
    g = host_rng(st.seed, "sample")
    code = st.dep.plan.n[files].astype(np.int64) * 256 + st.dep.k[files]
    picked: list[int] = []
    for c in np.unique(code):
        of_code = np.nonzero(code == c)[0]
        take = min(int(traffic["sample_reads_per_code"]), len(of_code))
        picked += g.choice(of_code, take, replace=False).tolist()
    rest = np.setdiff1d(np.arange(len(files)), picked)
    take = min(max(int(traffic["sample_reads"]) - len(picked), 0), len(rest))
    picked += g.choice(rest, take, replace=False).tolist()
    return np.sort(np.asarray(picked, np.int64))


def _accumulators(count: int) -> dict:
    return dict(done=np.full(count, np.nan), dispatched=np.zeros(count, bool),
                sets=None, kept={}, received=set(), batches=0, reads=0, decode_bytes=0,
                b3_bytes=0, backlog_at_close=0)


def _serve(st: State, lo: int, hi: int, t0: float) -> None:
    """One batch: the reads due in [lo, hi)."""
    sched, acc, sp, dev = st.sched, st.acc, st.spans, st.dep.device
    with sp("dispatch"):
        masks, _ = st.system.dispatch(sched.u[lo:hi], sched.prio[lo:hi], st.pi,
                                      sched.files_dev[lo:hi], st.avail)
        sets = masks.cpu().numpy().astype(bool)
    with sp("fetch"):
        if acc["sets"] is None:
            acc["sets"] = np.zeros((len(sched.t), sets.shape[1]), bool)
        acc["sets"][lo:hi] = sets
        acc["dispatched"][lo:hi] = True
        files = sched.files[lo:hi]
        rows = st.row_of[files]
        ok = (sets.sum(1) == st.dep.k[files]) & ~(sets & (rows < 0)).any(1)
        reqs = np.nonzero(ok)[0]
        pats = [rows[b][sets[b]] for b in reqs]
        by_code: dict = {}
        for j, b in enumerate(reqs):
            by_code.setdefault(st.store.where[int(files[b])][0], []).append(j)
        chunks = [None] * len(reqs)
        for (n, k), js in by_code.items():
            flat = st.flat[(n, k)]
            width = flat.shape[-1]
            got = torch.empty((len(js), k, width), dtype=torch.uint8, device=dev)
            for pos, j in enumerate(js):
                base = st.store.where[int(files[reqs[j]])][1] * n
                for c, row in enumerate(pats[j].tolist()):
                    got[pos, c].copy_(flat[base + row])  # one device copy a chunk row
                chunks[j] = got[pos]
            acc["decode_bytes"] += len(js) * roofline.decode_bytes(k, width)
            acc["b3_bytes"] += roofline.gf256_bytes(len(js), k, k, width)
    with sp("decode_requests"):
        decoded = st.system.decode(st.dep.plan, [int(files[b]) for b in reqs],
                                   [p.tolist() for p in pats], chunks)
    with sp("wait"):
        sync(dev)
    acc["done"][lo + reqs] = clock() - t0
    acc["batches"] += 1
    acc["reads"] += len(reqs)
    keep = np.searchsorted(st.sample, lo + reqs)
    for j, b in enumerate(reqs):
        if keep[j] < len(st.sample) and st.sample[keep[j]] == lo + b:
            # a copy, so the sample does not hold its whole batch's rows
            with sp("keep"):
                _keep(acc, lo + b, decoded[j] if j < len(decoded) else None)


def _keep(acc: dict, idx: int, got) -> None:
    buf = acc["kept"][idx]
    if got is not None and buf.shape == got.shape:
        buf.copy_(got)
        acc["received"].add(idx)


def _wait_until(when: float) -> None:
    """Sleep until about 2 ms before ``when``, then spin: a read is due at
    its time, not when the scheduler wakes the loop."""
    ahead = when - clock() - 2e-3
    if ahead > 0:
        time.sleep(ahead)
    while clock() < when:
        pass


def window(st: State) -> dict:
    sched, acc, sp = st.sched, st.acc, st.spans
    drain = float(st.cell.traffic["drain_limit_s"])
    count = len(sched.t)
    closed = False
    with sp("window"):
        t0 = clock()
        i = 0
        while i < count:
            now = clock() - t0
            if now >= st.seconds and not closed:
                acc["backlog_at_close"], closed = count - i, True
            if now > st.seconds + drain:
                break
            if sched.t[i] > now:
                with sp("idle"):
                    _wait_until(t0 + sched.t[i])
                continue
            j = min(int(np.searchsorted(sched.t, now, side="right")), i + st.max_batch)
            _serve(st, i, j, t0)
            i = j
        sync(st.dep.device)
        elapsed = clock() - t0
    lat_ms = (acc["done"] - sched.t) * 1e3
    missing = np.isnan(lat_ms)
    # a read that never completed is slower than any that did: it ranks at
    # its wait until the run ended, or above the slowest completed read
    slowest = float(np.nanmax(lat_ms)) if not missing.all() else 0.0
    ranked = np.where(missing, np.maximum((elapsed - sched.t) * 1e3, slowest), lat_ms)
    return dict(
        values=dict(read_p95_ms=percentile(ranked, 0.95)),
        attempted=count, failed=int(missing.sum()),
        counters=dict(batches=acc["batches"], reads=acc["reads"],
                      decode_bytes=acc["decode_bytes"], b3_bytes=acc["b3_bytes"]),
        info=dict(rate=st.rate, reads=count, read_p50_ms=percentile(ranked, 0.5),
                  batches=acc["batches"],
                  mean_batch=acc["reads"] / max(acc["batches"], 1),
                  backlog_at_close=acc["backlog_at_close"], elapsed_s=elapsed,
                  late_s=max(elapsed - st.seconds, 0.0)),
    )


def check(st: State) -> dict:
    """The numbers compared, each with its limit (all exact: 0)."""
    dep, acc, sched = st.dep, st.acc, st.sched
    done = acc["dispatched"]
    files = sched.files[done]
    compared = dict(
        bad_read_sets=ref_checks.bad_read_sets(acc["sets"][done], dep.k[files],
                                               st.row_of[files] >= 0, st.alive),
        missing_reads=int(np.isnan(acc["done"]).sum()),
        plan_violations=ref_checks.plan_violations(dep.pi, dep.k, dep.plan.n,
                                                   dep.plan.placement, dep.mask),
    )
    # the stored rows of a sample of files, then the program's state freed
    g = host_rng(st.seed, "sample-files")
    picks = [int(g.choice(files_of)) for files_of in deploy.groups(dep, dep.resident).values()]
    extra = min(int(st.cell.traffic["sample_files"]), len(dep.resident)) - len(picks)
    if extra > 0:
        picks += [int(f) for f in g.choice(dep.resident, extra, replace=False)]
    stored = {}
    for f in sorted(set(picks)):
        key, row = st.store.where[f]
        stored[f] = (key, st.store.tensors[key][row].clone())
    st.store, st.flat = None, {}
    if dep.device.type == "cuda":
        torch.cuda.empty_cache()
    bad = 0
    for idx in st.sample:
        f = int(sched.files[idx])
        want = payload((int(dep.k[f]), int(dep.row_bytes[f])), dep.device, st.seed, "file", f)
        got = acc["kept"][int(idx)] if int(idx) in acc["received"] else None
        bad += got is None or tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want)
    compared["bad_decoded_reads"] = int(bad)
    acc["kept"].clear()
    bad = 0
    for f, ((n, k), got) in stored.items():
        data = payload((k, int(dep.row_bytes[f])), dep.device, st.seed, "file", f)
        bad += not torch.equal(got, ref_gf.encode(data, n))
    compared["bad_stored_files"] = int(bad)
    return {name: (value, 0) for name, value in compared.items()}


def _control_dispatch(u, prio, pi, file_id, avail):
    masks = ref_fcfs.madow(u.cpu().numpy(), pi.cpu().numpy()[file_id.cpu().numpy()])
    return torch.as_tensor(masks), None


def control() -> System:
    """The reference's Madow sets read as drawn, with no spare fill: a read
    of a node that is down, which breaks the stated availability."""
    return System(dispatch=_control_dispatch)


def _decode_unchanged(plan, file_ids, patterns, chunks):
    return list(chunks)


def _decode_half(plan, file_ids, patterns, chunks):
    h = len(file_ids) // 2
    out = decode_requests(plan, file_ids[:h], patterns[:h], chunks[:h]) if h else []
    return list(out) + [torch.zeros_like(c) for c in chunks[h:]]


def _decode_altered(plan, file_ids, patterns, chunks):
    out = decode_requests(plan, file_ids, patterns, chunks)
    out[0][0, 0] ^= 1
    return out


def fault(name: str) -> System:
    """The decode with one of `system.FAULTS` planted."""
    decode = dict(unchanged=_decode_unchanged, half_batch=_decode_half,
                  altered=_decode_altered)[name]
    return System(decode=decode)
