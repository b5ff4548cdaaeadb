"""Probabilistic-scheduling request router for model serving.

The port of ``ReplicaPool`` and ``Router.plan`` / ``Router.route`` from
``repro/serving/router.py``. Inference replicas play the role of storage
nodes; request classes are the paper's files with k_i = 1. JLCM tunes the
dispatch probabilities pi to minimize mean latency + theta * replica cost;
the router then dispatches every request with Theorem-1 exact marginals
(Madow sampling). Hedged dispatch sends a request to 1 + hedge distinct
replicas and takes the first completion.

The plan is solved where the pool's tensors live; pi comes back to the host
once, as in the reference. Routing is host work on that pi. Where the
reference takes a key, ``route`` takes a ``torch.Generator`` or an explicit
uniform. The EWMA estimators, ``plan_sweep``, the failover table and the
replanners wait for ROADMAP A15.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from repro_torch.core import (
    JLCMProblem,
    ServiceMoments,
    madow_sample,
    project_capped_simplex,
    solve,
)


@dataclasses.dataclass
class ReplicaPool:
    moments: ServiceMoments  # per-replica service moments
    cost: Tensor  # per-replica provisioning cost

    @property
    def m(self) -> int:
        return int(self.cost.shape[0])


@dataclasses.dataclass
class Router:
    pool: ReplicaPool
    pi: np.ndarray  # (r, m) dispatch probabilities per request class
    hedge: int = 0  # extra replicas per request (first-wins)
    latency_bound: float = float("nan")

    @classmethod
    def plan(
        cls,
        pool: ReplicaPool,
        class_rates: Tensor,
        *,
        theta: float = 0.0,
        hedge: int = 0,
        max_iters: int = 200,
    ) -> "Router":
        lam = torch.as_tensor(class_rates, dtype=torch.float32, device=pool.cost.device)
        prob = JLCMProblem(
            lam=lam,
            k=torch.ones_like(lam),
            moments=pool.moments,
            cost=pool.cost,
            theta=theta,
        )
        sol = solve(prob, max_iters=max_iters)
        return cls(
            pool=pool,
            pi=sol.pi.cpu().numpy(),
            hedge=hedge,
            latency_bound=float(sol.latency_tight),
        )

    def route(
        self,
        class_id: int,
        *,
        generator: torch.Generator | None = None,
        u: float | None = None,
    ) -> list[int]:
        """Replica ids for one request (1 + hedge distinct replicas).

        The Madow uniform is ``u`` if given, else one draw from
        ``generator`` (on the host)."""
        if u is None:
            u = float(torch.rand((), generator=generator))
        pi = torch.from_numpy(np.asarray(self.pi[class_id], np.float32))
        if self.hedge > 0:
            kk = 1 + self.hedge
            pi = project_capped_simplex(pi[None] * kk, torch.tensor([float(kk)]))[0]
        mask = madow_sample(torch.tensor(u, dtype=torch.float32), pi)
        return [int(j) for j in np.flatnonzero(mask.numpy())]
