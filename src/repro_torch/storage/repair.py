"""Repair subsystem: reconstruction traffic as first-class background load.

The port of ``repro/storage/repair.py``. Like the reference, it works on
the plan's host-side numpy arrays; the feasible dispatch rows come from
the port's ``feasible_uniform`` on CPU tensors.

When a storage node fails, every chunk it held must be re-built: for each
affected file an (n_i, k_i)-coded stripe loses one chunk, and
reconstruction is a k_i-of-surviving fetch (then a degraded-read decode —
the batched codec path in `storage/codec.py`) followed by a re-write.
The follow-up literature (arXiv:1703.08337) identifies exactly this
regime — degraded reads plus repair load — as where tail latency is won
or lost, and the paper's own optimizer never sees it: its plans assume
client traffic alone.

This module turns a failure plus a placement into *measurable queueing
load*:

* :func:`lost_chunk_inventory` — which files lost how many chunks, read
  straight off the plan's placement matrix;
* :func:`build_repair_flow` — a :class:`RepairFlow`: one reconstruction-
  read row per catalog file (fixed shape, so segment schedules stack),
  with k_i-of-surviving dispatch over the file's surviving placement and
  arrival rate ``repair_rate`` split across affected files by lost-chunk
  share (a tunable repair *pacer*, the knob real systems expose);
* :func:`repair_schedule` — per-segment repair rows for a whole
  availability trace, shaped to ride through ``simulate_segments``
  (``storage/simulator.py``) as extra (pi, lam) rows whose per-segment
  rates are folded in via the simulator's per-file rate scaling;
* :func:`augment_plan` — append repair rows to a client plan for one
  segment (the closed-loop path).

The scenario engine (``scenarios/engine.py``) injects these rows under
every policy and the repair-aware ``AdaptiveReplanner``
(``serving/router.py``) folds them into its solves, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.projection import feasible_uniform


class RepairFlow(NamedTuple):
    """Reconstruction-read traffic for one failure state, fixed (r,) shape.

    One row per catalog file (unaffected files carry ``lam == 0`` and an
    inert feasible dispatch row, so shapes never change across segments):

    ``lam``   (r,) reconstruction reads/sec targeting each file's stripes
    ``pi``    (r, m) dispatch of those reads (mass k_i over the support)
    ``k``     (r,) read fan-out (the file's MDS k_i)
    ``mask``  (r, m) allowed support: surviving placement, widened to all
              available nodes when fewer than k_i placed chunks survive
              (the same spare-fallback convention as ``dispatch_masks``)
    ``lost``  (r,) lost-chunk counts behind the rates (the inventory)
    """

    lam: np.ndarray
    pi: np.ndarray
    k: np.ndarray
    mask: np.ndarray
    lost: np.ndarray

    @property
    def active(self) -> bool:
        return bool(self.lam.sum() > 0)


def lost_chunk_inventory(
    placement: np.ndarray, failed_nodes: np.ndarray
) -> np.ndarray:
    """(r,) chunks lost per file: placed chunks sitting on failed nodes.

    ``placement`` is the plan's (r, m) boolean S_i (chunk c of file i on
    the c-th placed node — `storage.codec.CodecPlan.chunk_nodes`);
    ``failed_nodes`` an (m,) boolean mask of down nodes.
    """
    placement = np.asarray(placement, bool)
    failed = np.asarray(failed_nodes, bool)
    return (placement & failed[None, :]).sum(-1).astype(np.int64)


def build_repair_flow(
    placement: np.ndarray,
    k: np.ndarray,
    avail: np.ndarray,
    repair_rate: float,
) -> RepairFlow:
    """Reconstruction flow for one availability state.

    ``repair_rate`` is the pacer: total reconstruction reads/sec the
    repair process issues while any chunk is lost, split across affected
    files proportionally to their lost-chunk count. Each read fans out to
    k_i of the file's *surviving* placed chunks; if fewer than k_i
    survive, the support widens to every available node (degraded
    convention — the queueing model reads a chunk-sized unit from
    whichever node serves it).
    """
    placement = np.asarray(placement, bool)
    avail = np.asarray(avail, bool)
    k = np.asarray(np.round(np.asarray(k)), np.float32)
    r, m = placement.shape
    lost = lost_chunk_inventory(placement, ~avail)
    total = int(lost.sum())
    lam = (
        repair_rate * lost / total if total else np.zeros(r)
    ).astype(np.float64)

    surviving = placement & avail[None, :]
    # rows with fewer than k surviving placed chunks (thin placements, or
    # inert lam == 0 rows whose placement the failure gutted) widen to all
    # available nodes so the dispatch row stays feasible
    thin = surviving.sum(-1) < k
    mask = np.where(thin[:, None], avail[None, :], surviving)
    pi = feasible_uniform(torch.from_numpy(mask), torch.from_numpy(k)).numpy()
    return RepairFlow(lam=lam, pi=pi, k=np.asarray(k), mask=mask, lost=lost)


def repair_schedule(
    placement: np.ndarray,
    k: np.ndarray,
    avail_trace: np.ndarray,
    repair_rate: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment repair rows for an (S, m) availability trace.

    Returns ``(lam_rep_seq, pi_rep_seq)`` of shapes (S, r) and (S, r, m):
    segment s carries reconstruction reads for exactly the chunks dead at
    s. A recovered node's chunks stop generating repair traffic (we model
    the replacement catching up from the live repair stream; tracking a
    backlog across recovery is the engine's job if a scenario wants it).
    """
    avail_trace = np.asarray(avail_trace, bool)
    flows = [
        build_repair_flow(placement, k, avail_trace[s], repair_rate)
        for s in range(avail_trace.shape[0])
    ]
    return (
        np.stack([f.lam for f in flows]),
        np.stack([f.pi for f in flows]),
    )


def augment_plan(
    pi: np.ndarray, lam: np.ndarray, flow: RepairFlow
) -> tuple[np.ndarray, np.ndarray]:
    """Append the repair rows to a client plan: (2r, m) pi, (2r,) lam.

    Rows [0, r) stay the client catalog; rows [r, 2r) are reconstruction
    reads. Simulation results are split back by ``file_id < r``
    (the reference's ``scenarios.engine`` and replanner do this).
    """
    pi_aug = np.concatenate([np.asarray(pi), flow.pi], axis=0)
    lam_aug = np.concatenate([np.asarray(lam), flow.lam], axis=0)
    return pi_aug, lam_aug
