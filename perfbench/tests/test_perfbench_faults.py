"""The check of the check: each cell driven on the CPU at a tiny size.

The program's own run comes out correct; the control (the reference with
one stated guarantee broken) and each fault of the timed path (a step that
returns its input unchanged, half of the batch left out, one answer
altered) come out not correct.
"""
from __future__ import annotations

import pytest

from perfbench.harness import bench
from perfbench.harness.system import FAULTS
from perfbench.tests import tiny

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]


def _driver(name):
    return bench.driver(bench.resolve(name))


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    out = tiny.run(name)
    assert out.correct, out.compared
    assert out.attempted > 0 and out.failed == 0
    assert {m["name"] for m in bench.resolve(name).end_to_end} == set(out.metrics)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    out = tiny.run(name, system=_driver(name).control())
    assert not out.correct, out.compared


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_is_not_correct(name, fault):
    out = tiny.run(name, system=_driver(name).fault(fault))
    assert not out.correct, out.compared
