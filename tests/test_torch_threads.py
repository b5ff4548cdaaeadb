"""The port's test modules run torch on one CPU thread.

The suite runs in parallel worker processes (pytest-xdist) that share the
machine's cores. Each worker's torch would otherwise start one intra-op
thread a core, so the workers' threads oversubscribe the cores, and the
port's many small CPU ops wait on one another's threads; on one thread
the solver's small ops also run about a fifth faster alone. Every
``tests/test_torch_*.py`` module imports the fixture: it is module-scoped
and autouse, and restores the thread count after the module.
"""
from pathlib import Path

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_module_with_the_fixture_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1


def test_every_port_test_module_imports_the_fixture():
    here = Path(__file__).resolve()
    for path in sorted(here.parent.glob("test_torch_*.py")):
        if path != here:
            assert ("from test_torch_threads import one_torch_thread"
                    in path.read_text()), path.name
