"""The port's closed loop against the reference's, on the CPU, at the sizes
of ``tests/test_scenarios.py``: ``node-failure`` scaled 0.4 (the dense
``AdaptiveReplanner`` with rollouts from the live carry) beside the static
and oblivious policies on the same draws.

Both packages run on the reference's draws (``test_torch_scenarios.py``'s
helpers): segments and rollouts alike. The loop feeds back, so a plan
that differs in the last bit can flip a Madow set and move later replans
(``ROADMAP.md`` §C); the tests hold the replan count, the telemetry, the
first replan's choice and plan, each segment's latencies bitwise until the
first flip and its clients' mean within a flip-scaled tolerance after it
(``assert_loop_tracks_reference``), and the orderings the reference's own
tests assert. The reference runs on its ``ref`` FCFS backend.
"""
import numpy as np
import pytest

import repro_torch.scenarios as PSC
from test_torch_scenarios import (
    _ref_initial,
    assert_loop_tracks_reference,
    closed_loop_pair,
    clusters,  # noqa: F401 (fixture)
    one_torch_thread,  # noqa: F401 (fixture)
    port_spec,
    ref_schedule_draws,
    ref_spec,
)


@pytest.fixture(scope="module")
def failure(clusters):
    spec_r, spec_p = ref_spec("node-failure", 0.4), port_spec("node-failure", 0.4)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, placement0 = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    open_loop = {p: PSC.run_scenario(spec_p, p, cluster=clusters[1], draws=draws,
                                     pi0=None if p == "oblivious" else pi0,
                                     placement0=placement0)
                 for p in ("static", "oblivious")}
    return pair, {**open_loop, "adaptive": pair["got"]}


def test_node_failure_adaptive_tracks_reference(failure):
    pair, _ = failure
    assert pair["got"].seg_mean.shape == (8,)
    assert_loop_tracks_reference(pair)


def test_node_failure_orderings(failure):
    """tests/test_scenarios.py::TestClosedLoop's claims on the port."""
    _, out = failure
    for o in out.values():
        assert np.isfinite(o.mean) and np.isfinite(o.p99)
    assert out["adaptive"].mean < out["oblivious"].mean
    assert out["adaptive"].mean < out["static"].mean
    assert out["adaptive"].degraded_frac < 0.01 and out["static"].degraded_frac > 0.1
    assert out["adaptive"].replans > 0 and out["static"].replans == 0
    assert out["static"].solve_iters == () and out["static"].row()["solve_iters"] == ""
