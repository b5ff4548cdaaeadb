"""The port's hierarchical and geo closed loops against the reference's, on
the CPU: ``hotspot_drift_hierarchical`` at r = 2000 and 800 requests a
segment (``tests/test_scenarios.py``'s size; ``HierarchicalReplanner``:
full re-solves on moment drift, incremental ones otherwise) and
``geo-client-shift`` scaled 0.2 (``GeoAdaptiveReplanner`` with geo
rollouts), both on the reference's draws. Held as in
``test_torch_scenarios_loop.py`` (``assert_loop_tracks_reference``), with
the orderings the reference's tests and ``benchmarks/scenario_suite.py``
assert.

The geo loop parts from the reference's at its third replan: the geo
solves stop in a flat valley (pi 2.3e-2 apart there, ``ROADMAP.md`` §C),
and Madow sets flip from then on (2, 85 and 6 in segments 3-5, each
segment's mean within 1e-2 a flip of the reference's). The sixth replan
picks the other candidate, so segment 6 is not compared by mean; the
seventh picks the reference's again, and segment 7 is held.
"""
import numpy as np
import pytest

import repro.scenarios as RSC
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
def hierarchical(clusters):
    ref = RSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    port = PSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    pair = closed_loop_pair(ref[0], port[0], clusters, hierarchy=(ref[1], port[1]))
    draws = ref_schedule_draws(ref[0], 800)
    static = PSC.run_scenario(port[0], "static", seed=0, cluster=clusters[1],
                              hierarchy=port[1], draws=draws)
    want_static = RSC.run_scenario(ref[0], "static", seed=0, hierarchy=ref[1])
    return pair, static, want_static


def test_hierarchical_loop_tracks_reference(hierarchical):
    pair, static, want_static = hierarchical
    got, want = pair["got"], pair["want"]
    assert got.resolved_counts == want.resolved_counts
    assert_loop_tracks_reference(pair)
    # the static plans are the two packages' own cluster solves
    np.testing.assert_allclose(static.mean, want_static.mean, rtol=1e-2)


def test_hierarchical_orderings_and_telemetry(hierarchical):
    """tests/test_scenarios.py::TestHierarchicalScenario's claims."""
    pair, static, _ = hierarchical
    o = pair["got"]
    assert np.isfinite(o.mean) and np.isfinite(o.p99) and np.isfinite(static.mean)
    assert o.mean < static.mean
    assert o.replans > 0
    assert len(o.solve_iters) == len(o.solve_walls) == len(o.resolved_counts) == o.replans
    assert o.rollout_walls == ()
    row = o.row()
    assert "resolved_clusters" in row and row["solve_iters"].count("|") == o.replans - 1


@pytest.fixture(scope="module")
def geo(clusters):
    spec_r, spec_p = ref_spec("geo-client-shift", 0.2, 300), port_spec("geo-client-shift", 0.2, 300)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, _ = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    static = PSC.run_scenario(spec_p, "static", cluster=clusters[1], pi0=pi0, draws=draws)
    return pair, static


def test_geo_loop_tracks_reference(geo):
    pair, _ = geo
    assert_loop_tracks_reference(pair)
    got, want = pair["got"], pair["want"]
    assert got.site_mean.shape == want.site_mean.shape == (4,)
    assert len(got.rollout_walls) == got.replans


def test_geo_orderings(geo):
    """scenario_suite.py's geo-client-shift gate: replans, and adaptive's
    mean below the static geo-oblivious plan's."""
    pair, static = geo
    ada = pair["got"]
    assert ada.replans > 0 and static.replans == 0
    assert ada.mean < static.mean
    assert np.isfinite(ada.site_mean).all() and np.isfinite(static.site_mean).all()
