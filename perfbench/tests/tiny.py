"""The benchmark's cells cut to a size a CPU test run holds.

Each configuration file and each traffic file carries its own cut under
`tiny`: every width stays (nodes, codes, k); the catalog, the resident
files, the file and block sizes, the fleet and the window shrink, and every
answer of the window is sampled, so that one altered answer shows.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from perfbench.harness import bench, runner
from perfbench.harness.common import clock


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in over.items():
        out[key] = _merge(out[key], value) if isinstance(value, dict) else value
    return out


def cell(name: str) -> bench.Cell:
    real = bench.resolve(name)
    return dataclasses.replace(real, config=_merge(real.config, real.config["tiny"]),
                               traffic=_merge(real.traffic, real.traffic["tiny"]))


def run(name: str, system=None, seed: int = 2**40 + 7, seconds: float = 0.3):
    return runner.run_cell(cell(name), seed, seconds, False, torch.device("cpu"), clock(),
                           system=system)
