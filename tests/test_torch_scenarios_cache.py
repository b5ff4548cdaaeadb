"""The port's cache-aware closed loop against the reference's, on the CPU:
``cache-outage`` scaled 0.2 with at least 300 requests a segment. The
adaptive loop feeds its rate estimator miss traffic, inverts it through the
deployed TTLs, re-derives TTLs, is forced to re-plan when the hot tier
goes down and comes back, and holds the storm plan through the outage;
both packages run on the reference's draws. Held as in
``test_torch_scenarios_loop.py`` (``assert_loop_tracks_reference``),
with the hot tier's hit share and storage cost, and with the gate of
``benchmarks/scenario_suite.py`` (adaptive below the cache-blind static
baseline on mean and windowed p99, at no more storage cost)."""
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
def outage(clusters):
    spec_r, spec_p = ref_spec("cache-outage", 0.2, 300), port_spec("cache-outage", 0.2, 300)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    _, placement0 = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    blind = PSC.run_scenario(spec_p, "static", cluster=clusters[1], placement0=placement0,
                             cache_aware=False, draws=draws)
    want_blind = RSC.run_scenario(spec_r, "static", seed=0, placement0=placement0,
                                  cache_aware=False)
    return pair, blind, want_blind


def test_cache_outage_tracks_reference(outage):
    pair, _, _ = outage
    assert_loop_tracks_reference(pair)
    got, want = pair["got"], pair["want"]
    # one replan a segment boundary outside the outage, the forced one at each
    # hot-tier flip, none inside it (the storm plan is held)
    assert got.replans == 6
    np.testing.assert_allclose(got.hit_frac, want.hit_frac, rtol=1e-3)
    np.testing.assert_allclose(got.storage_cost, want.storage_cost, rtol=1e-3)


def test_cache_blind_baseline_and_gate(outage):
    pair, blind, want_blind = outage
    ada = pair["got"]
    assert blind.policy == want_blind.policy == "static-cacheblind"
    np.testing.assert_allclose(blind.mean, want_blind.mean, rtol=1e-2)
    np.testing.assert_allclose(blind.storage_cost, want_blind.storage_cost, rtol=1e-3)
    assert ada.mean < blind.mean and ada.p99_windowed < blind.p99_windowed
    assert ada.storage_cost <= blind.storage_cost
    assert 0.0 < ada.hit_frac < 1.0
