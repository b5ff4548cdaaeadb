"""The guarantees a plan and its reads owe the configuration.

A plan (paper Theorem 1 and Lemma 4): each file's read probabilities lie in
[0, 1] and sum to its k; its code length n_i is the size of its placement;
where the configuration fixes a placement mask, nothing is read off it.
A read set: k distinct nodes, each up, each holding a chunk of the file.
"""
from __future__ import annotations

import numpy as np

ATOL = 1e-4  # the slack of a float32 row sum of k <= 8 terms


def plan_violations(pi: np.ndarray, k: np.ndarray, n: np.ndarray, placement: np.ndarray,
                    mask: np.ndarray | None = None) -> int:
    """Files whose plan breaks a stated guarantee."""
    pi = np.asarray(pi, np.float64)
    bad = (pi < -ATOL).any(-1) | (pi > 1 + ATOL).any(-1)
    bad |= np.abs(pi.sum(-1) - np.asarray(k)) > ATOL
    bad |= np.asarray(placement).sum(-1) != np.asarray(n)
    bad |= np.asarray(n) < np.asarray(k)
    if mask is not None:
        bad |= (~np.asarray(mask, bool) & (pi != 0)).any(-1)
        bad |= (np.asarray(placement, bool) & ~np.asarray(mask, bool)).any(-1)
    return int(bad.sum())


def bad_read_sets(sets: np.ndarray, k: np.ndarray, has_chunk: np.ndarray,
                  alive: np.ndarray) -> int:
    """Reads whose node set is not k distinct live nodes holding a chunk.

    ``sets`` (N, m) bool, ``k`` (N,), ``has_chunk`` (N, m) bool for each
    read's file, ``alive`` (m,) bool."""
    sets = np.asarray(sets, bool)
    wrong = sets.sum(-1) != np.asarray(k)
    wrong |= (sets & ~np.asarray(has_chunk, bool)).any(-1)
    wrong |= (sets & ~np.asarray(alive, bool)[None, :]).any(-1)
    return int(wrong.sum())
