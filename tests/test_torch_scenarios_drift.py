"""The port's closed loop under moment drift against the reference's, on the
CPU: ``hotspot-drift`` scaled 0.4 (``tests/test_scenarios.py``'s
``TestSolverTelemetry`` size), adaptive and static on the reference's
draws. Held as in ``test_torch_scenarios_loop.py``
(``assert_loop_tracks_reference``), with the telemetry the reference's
test asserts."""
import numpy as np
import pytest

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
import repro_torch.scenarios as PSC


@pytest.fixture(scope="module")
def drift(clusters):
    spec_r, spec_p = ref_spec("hotspot-drift", 0.4), port_spec("hotspot-drift", 0.4)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, placement0 = _ref_initial(spec_r, clusters[0])
    static = PSC.run_scenario(spec_p, "static", cluster=clusters[1], pi0=pi0,
                              placement0=placement0,
                              draws=ref_schedule_draws(spec_r, spec_r.requests_per_segment))
    return pair, static


def test_hotspot_drift_tracks_reference(drift):
    pair, _ = drift
    assert_loop_tracks_reference(pair)


def test_adaptive_records_iters_and_walls(drift):
    pair, static = drift
    out = pair["got"]
    assert out.replans > 0
    assert len(out.solve_iters) == len(out.solve_walls) == len(out.rollout_walls) == out.replans
    assert all(int(v) >= 1 for v in out.solve_iters) and all(v > 0.0 for v in out.solve_walls)
    row = out.row()
    assert row["solve_iters"].count("|") == out.replans - 1
    assert row["solve_wall_ms"].count("|") == out.replans - 1
    assert static.replans == 0 and static.solve_iters == () and static.solve_walls == ()
    assert static.row()["solve_iters"] == ""
    assert np.isfinite(out.mean) and np.isfinite(static.mean)
