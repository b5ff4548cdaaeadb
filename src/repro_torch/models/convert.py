"""Carry a parameter tree across from the reference, one leaf for one.

``params_from_numpy(tree)`` takes the reference's tree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and returns the same tree of tensors
on ``device``, the card unless the caller asks for the CPU, as every entry
point of the port does: dicts stay dicts, lists stay lists, tuples stay
tuples and NamedTuples (an ``AdamWState``, a ``TrainState``) keep their
type. The port's ``Model`` and ``AdamW`` read that tree as it is, so a test
can run both packages on the same weights and optimizer state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device="cuda") -> Any:
    return tree_map(lambda leaf: torch.from_numpy(np.array(leaf, copy=True)).to(device), tree)
