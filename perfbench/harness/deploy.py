"""Build a configuration's deployment through the program's set-up entries.

From the configuration's file: the nodes (`storage/cluster.py`'s `Cluster`),
the catalog (each file's k and read rate), the plan (`core/jlcm.py::solve`,
then `CodecPlan.from_solution`), and, for the data-plane cells, the store:
the resident files made from the seed on the device and coded once by
`encode_batch`, one sub-batch at a time.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.jlcm import JLCMProblem, solve
from repro_torch.storage.cluster import Cluster, StorageNode
from repro_torch.storage.codec import CodecPlan

from . import bench
from .common import clock, fill_payload, sync

ENCODE_BATCH_BYTES = 2 * 10**9  # data bytes a set-up encode call takes at most


def load_kernels(cell, parts: dict) -> None:
    """Build (first run of a checkout) or load the kernel library that the
    cell's driver names (its `KERNEL`)."""
    module = importlib.import_module(f"repro_torch.kernels.{bench.driver(cell).KERNEL}")
    start = clock()
    module.load_library()
    parts["kernels_s"] = clock() - start


def nodes(config: dict) -> list[dict]:
    """The configuration's nodes: name, site, overhead_s, bandwidth_mbps, cost."""
    spec = config["nodes"]
    if "list" in spec:
        keys = ("name", "site", "overhead_s", "bandwidth_mbps", "cost")
        return [dict(zip(keys, row)) for row in spec["list"]]
    h = spec["homogeneous"]
    bw = h["chunk_mb"] / h["sigma_s"]  # Fig. 6: sigma = chunk / bw
    return [dict(name=f"n{i}", site=h["site"], overhead_s=h["overhead_s"],
                 bandwidth_mbps=bw, cost=h["cost"]) for i in range(h["count"])]


def catalog(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each file's k and read rate (req/s, float32), in catalog order."""
    c = config["catalog"]
    i = np.arange(c["files"])
    k = np.asarray(c["k_cycle"], np.int64)[i % len(c["k_cycle"])]
    if "rate_cycle" in c:
        lam = np.asarray(c["rate_cycle"], np.float32)[i % len(c["rate_cycle"])]
    else:
        w = 1.0 / (i + 1.0) ** c["zipf_constant"]
        lam = (c["rate_total"] * w / w.sum()).astype(np.float32)
    return k, lam


def placement_mask(spec: dict, r: int, m: int) -> np.ndarray:
    """(r, m) bool: each file's ``width`` nodes spread over racks as evenly
    as the width allows, racks and nodes picked by a seeded permutation."""
    racks, per_rack, width = spec["racks"], spec["nodes_per_rack"], spec["width"]
    if racks * per_rack != m:
        raise ValueError(f"{racks} racks x {per_rack} nodes != {m} nodes")
    rng = np.random.default_rng(spec["seed"])
    mask = np.zeros((r, m), bool)
    for f in range(r):
        order = rng.permutation(racks)
        counts = [width // racks + (j < width % racks) for j in range(racks)]
        for rack, count in zip(order, counts):
            chosen = rng.permutation(per_rack)[:count]
            mask[f, rack * per_rack + chosen] = True
    return mask


@dataclasses.dataclass
class Deployment:
    config: dict
    device: torch.device
    cluster: Cluster
    k: np.ndarray  # (r,) per file
    lam: np.ndarray  # (r,) float32 read rates
    mask: np.ndarray | None  # (r, m) the configuration's placement, or None
    service_chunk_mb: float  # chunk size of the service moments and draws
    solution: object  # JLCMSolution, on the device
    plan: CodecPlan
    pi: np.ndarray  # (r, m) the plan's read probabilities, on the host
    resident: np.ndarray  # (R,) file ids held on the device
    row_bytes: np.ndarray  # (r,) bytes of one chunk row of each file

    @property
    def m(self) -> int:
        return self.cluster.m


def build(config: dict, device: torch.device, parts: dict) -> Deployment:
    """The deployment's plan: nodes, catalog, one JLCM solve, the codec plan."""
    ns = nodes(config)
    cluster = Cluster(tuple(StorageNode(n["name"], n["site"], float(n["overhead_s"]),
                                        float(n["bandwidth_mbps"]), float(n["cost"]))
                            for n in ns), device=device)
    k, lam = catalog(config)
    r, m = k.shape[0], cluster.m
    file_bytes = int(config["catalog"]["file_bytes"])
    chunk = config["plan"]["service_chunk_mb"]
    if chunk == "rate_weighted":  # the files' own chunk sizes, weighted by reads
        chunk = float(np.average(file_bytes / 1e6 / k, weights=lam))
    spec = config["plan"]["placement"]
    mask = None if spec == "support" else placement_mask(spec, r, m)
    prob = JLCMProblem(
        lam=torch.as_tensor(lam, device=device), k=torch.as_tensor(k, dtype=torch.float32,
                                                                    device=device),
        moments=cluster.moments(float(chunk)), cost=cluster.cost,
        theta=float(config["plan"]["theta"]),
        mask=None if mask is None else torch.as_tensor(mask, device=device))
    sync(device)
    start = clock()
    sol = solve(prob, eps=config["plan"]["eps"], max_iters=config["plan"]["max_iters"])
    pi = sol.pi.cpu().numpy()
    parts["solve_s"] = clock() - start
    parts["solve_iterations"] = int(sol.iterations)
    if mask is not None:
        # the configuration fixes the code and its placement; the plan
        # chooses only how reads spread over it
        parts["plan_support_min"] = int(sol.n.min())
        sol = sol._replace(n=torch.full((r,), int(mask[0].sum()), device=device),
                           placement=torch.as_tensor(mask, device=device))
    plan = CodecPlan.from_solution(sol, prob.k)
    resident = np.arange(int(config["resident"]))
    return Deployment(config=config, device=device, cluster=cluster, k=k, lam=lam, mask=mask,
                      service_chunk_mb=float(chunk), solution=sol, plan=plan, pi=pi,
                      resident=resident, row_bytes=-(-file_bytes // k))


def groups(dep: Deployment, files: np.ndarray) -> dict[tuple[int, int], np.ndarray]:
    """``files`` by their (n, k) code, in file order."""
    n = dep.plan.n[files]
    out: dict[tuple[int, int], list[int]] = {}
    for f, nn in zip(files, n):
        out.setdefault((int(nn), int(dep.k[f])), []).append(int(f))
    return {key: np.asarray(v) for key, v in sorted(out.items())}


@dataclasses.dataclass
class Store:
    """The resident files' coded rows: one (files, n, L) tensor a code."""

    tensors: dict[tuple[int, int], Tensor]
    where: dict[int, tuple[tuple[int, int], int]]  # file -> (code, row)

    def nbytes(self) -> int:
        return sum(t.numel() for t in self.tensors.values())


def build_store(dep: Deployment, seed: int, encode) -> Store:
    """Code every resident file once with ``encode`` (the program's
    `encode_batch`), a sub-batch of at most ENCODE_BATCH_BYTES at a time."""
    tensors, where = {}, {}
    for (n, k), files in groups(dep, dep.resident).items():
        width = int(dep.row_bytes[files[0]])
        out = torch.empty((len(files), n, width), dtype=torch.uint8, device=dep.device)
        step = max(1, ENCODE_BATCH_BYTES // (k * width))
        for lo in range(0, len(files), step):
            chunk = files[lo:lo + step]
            data = torch.empty((len(chunk), k, width), dtype=torch.uint8, device=dep.device)
            for row, f in enumerate(chunk):
                fill_payload(data[row], seed, "file", int(f))
            out[lo:lo + len(chunk)].copy_(encode(data, n))
            del data
        tensors[(n, k)] = out
        where.update({int(f): ((n, k), row) for row, f in enumerate(files)})
    return Store(tensors, where)


def patterns(n: int, k: int, live_rows, limit: int = 5000):
    """Every k-subset of ``live_rows`` in order, or None past ``limit``."""
    live = sorted(live_rows)
    count = 1
    for i in range(k):
        count = count * (len(live) - i) // (i + 1)
    if count > limit:
        return None
    return [list(c) for c in itertools.combinations(live, k)]
