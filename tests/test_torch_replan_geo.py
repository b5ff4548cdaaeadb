"""The port's ``HierarchicalReplanner`` (the contracts of
``tests/test_serving.py``) and ``GeoAdaptiveReplanner`` against the
reference, on the CPU: plans within the flat-valley tolerance of
``ROADMAP.md`` §C, the same re-solved cluster counts, and the geo batched
arbitration equal to its sequential loop bitwise, on the reference's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as R
import repro.serving as RSV
import repro.storage as RS
import repro_torch.core as P
import repro_torch.serving as PSV
import repro_torch.storage as PS
from test_torch_replan import (
    K4, LAM, N_REQ, PI_ATOL, _assert_replans_agree, fabrics,  # noqa: F401 (fixture)
)
from test_torch_segments import seg_draws, stack_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


# ---------------------------------------------------- HierarchicalReplanner


def _hier(r=1500, seed=0):
    """tests/test_serving.py's TestHierarchicalReplanner set-up, both packages."""
    rng = np.random.default_rng(seed)
    cat = R.synthetic_catalog(r, total_rate=0.04, seed=seed)
    m = 8
    mu = rng.uniform(4.0, 8.0, m).astype(np.float32)
    cost = rng.uniform(0.5, 2.0, m)
    kw = dict(cost=cost, theta=2.0 * 4 / r, eps=1e-3)
    ref = RSV.HierarchicalReplanner(
        hierarchy=R.cluster_catalog(cat),
        estimator=RSV.EwmaMomentEstimator(prior=R.exponential_moments(jnp.asarray(mu))), **kw)
    pcat = P.synthetic_catalog(r, total_rate=0.04, seed=seed)
    port = PSV.HierarchicalReplanner(
        hierarchy=P.cluster_catalog(pcat),
        estimator=PSV.EwmaMomentEstimator(prior=P.exponential_moments(torch.from_numpy(mu))),
        **kw)
    return ref, port, pcat, np.ones(m, bool)


def test_hierarchical_first_replan_is_full_materialized_and_matches_reference():
    ref, rp, cat, avail = _hier()
    pi = rp.replan(cat.lam, avail)
    want = ref.replan(cat.lam, avail)
    assert pi.shape == (cat.r, avail.size) and isinstance(pi, np.ndarray)
    assert rp.replans == 1 and rp.full_solves == 1 and rp.plan is not None
    np.testing.assert_allclose(pi.sum(-1), cat.k, rtol=1e-3)
    assert len(rp.solve_iters) == len(rp.solve_walls) == 1
    assert rp.resolved_counts == ref.resolved_counts == [rp.hierarchy.n_clusters]
    np.testing.assert_array_equal(rp.cluster_rates(cat.lam), ref.cluster_rates(cat.lam))
    np.testing.assert_allclose(pi, want, atol=PI_ATOL)


def test_hierarchical_quiet_segment_is_incremental_noop():
    _, rp, cat, avail = _hier()
    pi1 = rp.replan(cat.lam, avail)
    pi2 = rp.replan(cat.lam, avail)
    assert rp.replans == 2 and rp.full_solves == 1
    assert rp.resolved_counts[-1] == 0
    np.testing.assert_array_equal(pi1, pi2)


def test_hierarchical_rate_surge_resolves_few_clusters_like_reference():
    ref, rp, cat, avail = _hier()
    rp.replan(cat.lam, avail)
    ref.replan(cat.lam, avail)
    cid = rp.hierarchy.cluster_of_file()
    rates = cat.lam.copy()
    rates[cid == int(np.argmax(rp.hierarchy.lam))] *= 3.0  # one cluster surges
    pi = rp.replan(rates, avail)
    want = ref.replan(rates, avail)
    assert rp.full_solves == 1
    assert 1 <= rp.resolved_counts[-1] < rp.hierarchy.n_clusters
    assert rp.resolved_counts == ref.resolved_counts
    np.testing.assert_allclose(pi, want, atol=PI_ATOL)


def test_hierarchical_mask_change_and_moment_drift_force_full_solves():
    _, rp, cat, avail = _hier()
    rp.replan(cat.lam, avail)
    down = avail.copy()
    down[0] = False
    pi = rp.replan(cat.lam, down)
    assert rp.full_solves == 2
    np.testing.assert_allclose(pi[:, 0], 0.0, atol=1e-6)
    rp.estimator.m1 *= 1.5  # a node slowed: no rate diff sees this
    rp.replan(cat.lam, down)
    assert rp.full_solves == 3 and rp.resolved_counts[-1] == rp.hierarchy.n_clusters


# ---------------------------------------------------- GeoAdaptiveReplanner


def test_geo_replan_matches_reference(fabrics):
    ref_fab, fab = fabrics
    common = dict(k=K4.copy(), theta=2.0, max_iters=80, rollout_requests=N_REQ)
    ref = RSV.GeoAdaptiveReplanner(cost=np.asarray(ref_fab.cluster.cost),
                                   estimator=RSV.EwmaMomentEstimator(prior=ref_fab.moments(12.5)),
                                   **common)
    port = [PSV.GeoAdaptiveReplanner(cost=fab.cluster.cost.numpy(), rollout_batched=batched,
                                     estimator=PSV.EwmaMomentEstimator(prior=fab.moments(12.5)),
                                     **common)
            for batched in (True, False)]
    lam_cs = np.asarray(ref_fab.uniform_mix(4)).T * LAM
    lam_cs[:, 3] = 0.0  # a file at zero rate gets the population-average mix
    key = jax.random.key(13)
    avail = np.ones(12, bool)
    pi0 = np.asarray(R.feasible_uniform(jnp.ones((4, 12), bool), jnp.asarray(K4)))
    want = ref.replan(lam_cs, avail, carry=RS.init_carry(12), key=key, pi0=pi0)
    draws = stack_draws([seg_draws(key, jnp.asarray(lam_cs, jnp.float32), N_REQ, geo=True)])
    got, got_seq = (rp.replan(lam_cs, avail, carry=PS.init_carry(12, device="cpu"), draws=draws,
                              pi0=pi0) for rp in port)
    _assert_replans_agree(ref, port, got, want, got_seq)
    assert np.asarray(port[0].last_scores).shape == (2,)
    np.testing.assert_allclose(port[0].replan(lam_cs, avail), ref.replan(lam_cs, avail),
                               atol=PI_ATOL)
