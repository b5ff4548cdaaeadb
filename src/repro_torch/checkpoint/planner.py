"""JLCM-planned erasure-coded checkpoint placement (paper-as-a-feature).

The port of ``repro/checkpoint/planner.py``. A model's checkpoint set IS
the paper's "r files": parameter leaves are packed into shard-groups of
~group_mb; each group i becomes a file with k_i = ceil(bytes / chunk_mb)
data chunks. Algorithm JLCM then jointly chooses the code length n_i, the
placement S_i over storage nodes, and the read-dispatch probabilities
pi_{i,j} minimizing expected restore latency + theta * storage cost.

Restores tolerate any (n_i - k_i) node failures per group; reads dispatch
to k_i nodes sampled with Theorem-1 exact marginals (Madow), i.e. the
paper's probabilistic scheduling is literally the read path.

A parameter tree is the nested dict / list / tuple of tensors the port's
``Model`` holds, or a NamedTuple of such trees (the trainer's
``TrainState``). ``repro_torch.tree.flatten_with_keys`` walks and names its
leaves exactly as the reference's ``jax.tree_util.tree_flatten_with_path``
and ``keystr`` do (names like ``['stack']['period'][0]['attn']['wq']`` or
``.opt.m['embed']``), so groups, manifests and chunk files agree byte for
byte between the packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import (
    JLCMProblem,
    JLCMSolution,
    madow_sample,
    project_capped_simplex,
    solve,
)
from repro_torch.storage.cluster import Cluster
from repro_torch.tree import flatten_with_keys


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    name: str
    leaves: tuple[str, ...]  # flattened leaf keys in this group
    nbytes: int
    k: int
    n: int
    placement: tuple[int, ...]  # node ids hosting chunks (len n)
    pi: np.ndarray  # (m,) dispatch probabilities


@dataclasses.dataclass(frozen=True)
class CheckpointPlan:
    groups: tuple[GroupPlan, ...]
    cluster_size: int
    chunk_mb: float
    theta: float
    latency_bound: float
    storage_cost: float

    def replan_after_failure(
        self, cluster: Cluster, failed: set[int], read_rate: float
    ) -> "CheckpointPlan":
        """Elastic replan on the surviving node set (paper §V 'dynamic
        file management'): re-solve JLCM with failed nodes masked out."""
        alive = [j for j in range(cluster.m) if j not in failed]
        sizes = [g.nbytes for g in self.groups]
        ks = [g.k for g in self.groups]
        return plan_checkpoint_layout(
            sizes,
            ks,
            cluster.subset(alive),
            chunk_mb=self.chunk_mb,
            theta=self.theta,
            read_rate=read_rate,
            names=[g.name for g in self.groups],
            leaves=[g.leaves for g in self.groups],
            node_ids=alive,
        )


def leaf_nbytes(leaf: Any) -> int:
    """Bytes of one leaf (a tensor, also on the ``meta`` device)."""
    leaf = torch.as_tensor(leaf)
    return int(np.prod(leaf.shape)) * leaf.element_size()


def pack_groups(abstract_params: Any, group_mb: float = 64.0):
    """Pack param leaves into ~group_mb shard-groups (greedy first-fit by
    traversal order, splitting nothing — large leaves become their own
    group)."""
    limit = int(group_mb * 2**20)
    groups: list[tuple[list[str], int]] = []
    cur_keys: list[str] = []
    cur_bytes = 0
    for key, leaf in flatten_with_keys(abstract_params):
        nbytes = leaf_nbytes(leaf)
        if cur_bytes and cur_bytes + nbytes > limit:
            groups.append((cur_keys, cur_bytes))
            cur_keys, cur_bytes = [], 0
        cur_keys.append(key)
        cur_bytes += nbytes
    if cur_keys:
        groups.append((cur_keys, cur_bytes))
    return groups


def plan_checkpoint_layout(
    group_bytes: list[int],
    ks: list[int],
    cluster: Cluster,
    *,
    chunk_mb: float = 16.0,
    theta: float = 0.1,
    read_rate: float = 1 / 600.0,
    names: list[str] | None = None,
    leaves: list[tuple[str, ...]] | None = None,
    node_ids: list[int] | None = None,
    max_iters: int = 150,
    min_spare: int = 2,
) -> CheckpointPlan:
    """Solve JLCM for the checkpoint catalog (on the cluster's device) and
    materialize placements.

    ``min_spare`` is a durability floor BEYOND the paper's objective: the
    floor places n_i >= k_i + min_spare chunks (at most m); cold spares
    carry pi ~= 0 and are only read after failures — consistent with
    Theorem 1 (pi = 0 on placed nodes is feasible)."""
    r, m = len(group_bytes), cluster.m
    dev = cluster.device
    prob = JLCMProblem(
        lam=torch.full((r,), read_rate, dtype=torch.float32, device=dev),
        k=torch.tensor([float(k) for k in ks], dtype=torch.float32, device=dev),
        moments=cluster.moments(chunk_mb),
        cost=cluster.cost,
        theta=theta,
    )
    sol: JLCMSolution = solve(prob, max_iters=max_iters)
    pi_all = sol.pi.cpu().numpy()
    placement_all = sol.placement.cpu().numpy()
    cost = cluster.cost.cpu().numpy()
    node_ids = node_ids or list(range(m))
    groups = []
    for i in range(r):
        pi_i = pi_all[i]
        placed = np.where(placement_all[i])[0]
        k_i = ks[i]
        n_floor = min(k_i + min_spare, m)
        if len(placed) < n_floor:  # durability floor: add cheapest spares
            extra = [
                j
                for j in np.lexsort((cost, -pi_i))
                if j not in set(placed.tolist())
            ]
            placed = np.concatenate(
                [placed, np.asarray(extra[: n_floor - len(placed)], placed.dtype)]
            )
        groups.append(
            GroupPlan(
                name=names[i] if names else f"group{i}",
                leaves=tuple(leaves[i]) if leaves else (),
                nbytes=int(group_bytes[i]),
                k=k_i,
                n=len(placed),
                placement=tuple(int(node_ids[j]) for j in placed),
                pi=pi_i,
            )
        )
    return CheckpointPlan(
        groups=tuple(groups),
        cluster_size=m,
        chunk_mb=chunk_mb,
        theta=theta,
        latency_bound=float(sol.latency_tight),
        storage_cost=float(sol.cost),
    )


def plan_for_params(
    abstract_params: Any,
    cluster: Cluster,
    *,
    group_mb: float = 64.0,
    chunk_mb: float = 16.0,
    theta: float = 0.1,
    read_rate: float = 1 / 600.0,
) -> CheckpointPlan:
    """Plan a parameter tree: its leaves (tensors, ``meta`` ones too) packed
    into groups, each group's k from its bytes, the layout from JLCM."""
    packed = pack_groups(abstract_params, group_mb)
    sizes = [b for _, b in packed]
    ks = [max(1, min(int(np.ceil(b / (chunk_mb * 2**20))), cluster.m - 1)) for b in sizes]
    return plan_checkpoint_layout(
        sizes,
        ks,
        cluster,
        chunk_mb=chunk_mb,
        theta=theta,
        read_rate=read_rate,
        names=[f"group{i}" for i in range(len(packed))],
        leaves=[tuple(keys) for keys, _ in packed],
    )


def sample_read_set(
    u: torch.Generator | float, plan: GroupPlan, alive: set[int], m: int
) -> list[int]:
    """Probabilistic-scheduling read: Madow-sample k nodes from pi,
    restricted (re-projected) to surviving placement nodes. ``u`` is the
    one U[0, 1) draw the sample takes, or a (host) ``torch.Generator`` to
    draw it from. Host control: m floats, on the CPU."""
    mask = np.zeros((m,), bool)
    for j in plan.placement:
        mask[j] = j in alive
    if mask.sum() < plan.k:
        raise RuntimeError(
            f"{plan.name}: only {int(mask.sum())} of n={plan.n} chunks alive, "
            f"need k={plan.k} — data loss"
        )
    pi = project_capped_simplex(
        torch.tensor(np.asarray(plan.pi), dtype=torch.float32)[None],
        torch.tensor([float(plan.k)]),
        torch.as_tensor(mask)[None],
    )[0]
    if isinstance(u, torch.Generator):
        u = torch.rand((), generator=u, dtype=torch.float32)
    sel = np.where(madow_sample(torch.as_tensor(u, dtype=torch.float32), pi).numpy())[0]
    return [int(j) for j in sel]
