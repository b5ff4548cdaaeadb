"""Carry a parameter tree across from the reference, one leaf for one.

``params_from_numpy(tree)`` takes the reference's tree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and returns the same tree of tensors
on ``device``, the card unless the caller asks for the CPU, as every entry
point of the port does: dicts stay dicts, lists stay lists, tuples stay
tuples and NamedTuples (an ``AdamWState``, a ``TrainState``) keep their
type. Each leaf keeps its dtype, bfloat16 included (numpy holds it as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take, so its
bits go across as uint16), so an MoE tree keeps its float32 router beside
bfloat16 experts. The port's ``Model`` and ``AdamW`` read that tree as it
is, so a test can run both packages on the same weights and optimizer
state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _tensor(leaf) -> torch.Tensor:
    x = np.array(leaf, copy=True)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    return tree_map(lambda leaf: _tensor(leaf).to(device), tree)
