"""Objective layer: the ``spec=None`` path of the reference.

The paper optimizes ONE scalar: the request-weighted mean latency bound
(Lemma 2 / Eq. 5) plus theta x storage cost. The reference composes that
with per-class weights, tail terms, a geo fabric and a cache tier; this
slice of the port carries the paper's objective only. Any of those
arguments other than ``None`` raises ``NotImplementedError`` (see
ROADMAP.md queue A, step 6).
"""
from __future__ import annotations

import torch
from torch import Tensor

from .latency_bound import optimal_shared_z, shared_z_latency
from .queueing import ServiceMoments


def _paper_objective_only(**parts) -> None:
    given = sorted(name for name, value in parts.items() if value is not None)
    if given:
        raise NotImplementedError(
            f"{', '.join(given)} not supported by the PyTorch port yet; only "
            "the paper's uniform objective is (ROADMAP.md, queue A)"
        )


def apply_cache_thinning(lam: Tensor, cache) -> Tensor:
    """Warm-tier arrival rates; ``cache=None`` returns ``lam`` unchanged."""
    _paper_objective_only(cache=cache)
    return lam


def composed_latency(
    pi: Tensor,
    z: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    spec,
    geo=None,
    cache=None,
    *,
    background=None,
) -> Tensor:
    """The solver-facing latency objective at shared auxiliary z.

    With every optional part ``None`` this IS ``shared_z_latency``.
    """
    _paper_objective_only(spec=spec, geo=geo, cache=cache, background=background)
    return shared_z_latency(pi, z, lam, moments)


def refresh_shared_z(
    pi: Tensor,
    lam: Tensor,
    moments: ServiceMoments,
    spec,
    geo=None,
    cache=None,
    *,
    background=None,
) -> Tensor:
    """argmin_z of :func:`composed_latency`: the solver's z-refresh step."""
    _paper_objective_only(spec=spec, geo=geo, cache=cache, background=background)
    return optimal_shared_z(pi, lam, moments)


def compose_file_bounds(
    t_files: Tensor,
    pi: Tensor,
    eq: Tensor,
    varq: Tensor,
    lam: Tensor,
    spec,
    cache=None,
) -> Tensor:
    """Composed objective value from per-file tight bounds (reporting):
    the request-weighted mean of ``t_files``."""
    _paper_objective_only(spec=spec, cache=cache)
    return torch.sum(lam * t_files, dim=-1) / torch.sum(lam, dim=-1)
