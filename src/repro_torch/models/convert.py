"""Carry a parameter tree across from the reference, one leaf for one.

``params_from_numpy(tree)`` takes the reference's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the same tree of
tensors on ``device``, the card unless the caller asks for the CPU, as
every entry point of the port does: dicts stay dicts, lists stay lists,
tuples stay tuples. The port's ``Model`` reads that tree as it is, so a
test can run both packages on the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cuda") -> Any:
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(val, device) for val in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
