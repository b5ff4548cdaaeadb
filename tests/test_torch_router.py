"""The port's serving router and the control plane's estimators against the
reference, on the CPU, at the sizes of ``tests/test_serving.py`` and
``benchmarks/serving_hedge.py``, on the reference's own draws.

* ``Router.plan_sweep``, the failover table and ``drop_replica``;
* both EWMA estimators, bitwise on the same observations;
* ``simulate_serving`` bitwise at hedge 0, 1 and 2 (B1's plain twin here).

``tests/test_torch_replan.py`` and ``tests/test_torch_replan_geo.py`` hold
the replanners. No test launches a kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.serving as RSV
import repro.storage as RS
import repro_torch.core as P
import repro_torch.serving as PSV
import repro_torch.storage as PS
from repro.storage.simulator import generate_workload
from repro_torch.serving.router import ServingDraws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MU = [1.0, 1.2, 0.8, 1.5, 0.9, 1.1]  # tests/test_serving.py, benchmarks/serving_hedge.py
RATES = np.asarray([0.5, 0.8], np.float32)
CHUNK_MB = 150.0 / 4
PI_ATOL = 2e-3  # flat-valley stops (ROADMAP.md §C: Router.plan ends 1.4e-3 apart)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def pools():
    mu = np.asarray(MU, np.float32)
    return (RSV.ReplicaPool(moments=R.exponential_moments(jnp.asarray(mu)), cost=jnp.ones((6,))),
            PSV.ReplicaPool(moments=P.exponential_moments(torch.tensor(mu)), cost=torch.ones(6)))


@pytest.fixture(scope="module")
def clusters():
    return RS.tahoe_testbed(), PS.tahoe_testbed(device="cpu")


@pytest.fixture(scope="module")
def fabrics():
    return RS.geo_testbed(), PS.geo_testbed(PS.tahoe_testbed(device="cpu"))


# ------------------------------------------------------------------ Router


def test_plan_sweep_matches_single_plans_and_reference(pools):
    ref_pool, pool = pools
    thetas = (0.0, 0.5, 2.0)
    routers = PSV.Router.plan_sweep(pool, RATES, thetas)
    ref = RSV.Router.plan_sweep(ref_pool, jnp.asarray(RATES), thetas)
    assert len(routers) == len(thetas)
    for theta, r, want in zip(thetas, routers, ref):
        single = PSV.Router.plan(pool, RATES, theta=theta)
        np.testing.assert_allclose(r.latency_bound, single.latency_bound, rtol=1e-3)
        np.testing.assert_allclose(r.latency_bound, want.latency_bound, rtol=1e-3)
        np.testing.assert_allclose(r.pi, np.asarray(want.pi), atol=PI_ATOL)
        assert isinstance(r.pi, np.ndarray) and r.failover == {}


def test_precomputed_failover_matches_fresh_solve_and_reference(pools):
    ref_pool, pool = pools
    r = PSV.Router.plan(pool, RATES).precompute_failover(RATES)
    ref = RSV.Router.plan(ref_pool, jnp.asarray(RATES)).precompute_failover(jnp.asarray(RATES))
    assert sorted(r.failover) == list(range(pool.m))
    np.testing.assert_array_equal(r.failover_inputs[0], RATES)
    # the table's 150 iterations stop short of the flat valley's floor in
    # both packages, on paths a last bit apart: held on support and bound
    # (within 1 %), not pi (ROADMAP.md §C)
    for j in range(pool.m):
        assert (r.failover[j][0][:, j] <= 1e-6).all()
        np.testing.assert_allclose(r.failover[j][1], ref.failover[j][1], rtol=1e-2)
    fresh = PSV.Router.plan(pool, RATES)  # no table: solves on drop
    for j in (0, 3):
        from_table = r.drop_replica(j, RATES)
        from_solve = fresh.drop_replica(j, RATES)
        assert (from_table.pi[:, j] <= 1e-6).all()
        np.testing.assert_allclose(from_table.pi, from_solve.pi, atol=1e-5)
        np.testing.assert_allclose(from_table.latency_bound, from_solve.latency_bound, rtol=1e-5)
        np.testing.assert_allclose(from_table.pi.sum(-1), 1.0, atol=1e-3)
        assert from_table.failover == {} and from_table.failover_inputs is None


def test_stale_failover_table_is_ignored(pools):
    _, pool = pools
    r = PSV.Router.plan(pool, RATES).precompute_failover(RATES)
    shifted = np.asarray([1.0, 0.2], np.float32)  # traffic shifted since precompute
    stale = r.failover[3][0]
    replanned = r.drop_replica(3, shifted)
    assert (replanned.pi[:, 3] <= 1e-6).all()
    assert not np.allclose(replanned.pi, stale, atol=1e-6)
    # another theta is stale too: the drop solves the masked problem there
    other = r.drop_replica(3, RATES, theta=0.5)
    fresh = dataclasses.replace(r, failover={}, failover_inputs=None).drop_replica(
        3, RATES, theta=0.5)
    np.testing.assert_array_equal(other.pi, fresh.pi)
    assert other.failover == {} and other.failover_inputs is None


# -------------------------------------------------------------- estimators


def _observations(rng, m, lead=()):
    count = rng.integers(0, 40, lead + (m,)).astype(np.int32)
    count[..., 1] = 0  # a node that served nothing keeps its estimate
    s1 = count * rng.uniform(10.0, 20.0, lead + (m,))
    s2 = s1 * rng.uniform(12.0, 25.0, lead + (m,))
    s3 = s2 * rng.uniform(14.0, 30.0, lead + (m,))
    return [x.astype(np.float32) for x in (count, s1, s2, s3)]


@pytest.mark.parametrize("geo", [False, True])
def test_moment_estimator_is_bitwise(clusters, fabrics, geo):
    ref_prior = fabrics[0].moments(12.5) if geo else clusters[0].moments(CHUNK_MB)
    # the same prior in both (the testbeds' E[X^3] differ in the last bit)
    prior = P.ServiceMoments(*(_t(x) for x in ref_prior))
    ref = RSV.EwmaMomentEstimator(prior=ref_prior)
    port = PSV.EwmaMomentEstimator(prior=prior)
    rng = np.random.default_rng(3)
    lead = tuple(np.shape(np.asarray(ref_prior.mu))[:-1])
    for step in range(4):
        obs = _observations(rng, 12, lead)
        want = ref.update(RS.NodeObservations(*(jnp.asarray(x) for x in obs)))
        got = port.update(PS.NodeObservations(*(torch.from_numpy(x) for x in obs)))
        for name in ("m1", "m2", "m3"):
            np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(port.fitted_shifted_exp(), ref.fitted_shifted_exp()):
        np.testing.assert_array_equal(g, w)
    # the device of the prior's tensors carries through
    assert port.moments().mu.device == prior.mu.device


def test_rate_estimator_is_bitwise_with_dropped_ids_and_misses():
    ref = RSV.EwmaRateEstimator(prior=np.asarray([0.1, 0.1, 0.1]), alpha=1.0)
    port = PSV.EwmaRateEstimator(prior=np.asarray([0.1, 0.1, 0.1]), alpha=1.0)
    # repair rows ride at ids r..2r-1 (tests/test_serving.py's regression)
    ids = np.asarray([0, 1, 2, 3, 4, 5, 0, 1, -1])
    np.testing.assert_array_equal(port.update(torch.from_numpy(ids), 10.0),
                                  ref.update(ids, 10.0))
    np.testing.assert_allclose(port.rates, [0.2, 0.2, 0.1])
    assert port.dropped == ref.dropped == 4
    rng = np.random.default_rng(5)
    for alpha in (0.5, 0.3):
        ref2 = RSV.EwmaRateEstimator(prior=np.asarray([0.04, 0.03, 0.02]), alpha=alpha)
        port2 = PSV.EwmaRateEstimator(prior=np.asarray([0.04, 0.03, 0.02]), alpha=alpha)
        for _ in range(3):
            ids = rng.integers(0, 6, 500)
            hit = rng.random(500) < 0.3
            np.testing.assert_array_equal(
                port2.update_misses(torch.from_numpy(ids), torch.from_numpy(hit), 300.0),
                ref2.update_misses(ids, hit, 300.0))
        assert port2.dropped == ref2.dropped > 0


# -------------------------------------------------------- simulate_serving


def _serving_draws(key, rate, n):
    """The reference ``simulate_serving``'s draws for ``key``: workload,
    Madow uniforms (one key per request) and the benchmark's sampler."""
    k_wl, k_route, k_srv = jax.random.split(key, 3)
    arrival, cid = generate_workload(k_wl, jnp.asarray(rate), n)
    service = jax.random.exponential(k_srv, (n, 6)) / jnp.asarray(MU)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(jax.random.split(k_route, n))
    return ServingDraws(_t(arrival), _t(cid, torch.int64), _t(u), _t(service))


@pytest.mark.parametrize("hedge", [0, 1, 2])
def test_simulate_serving_is_bitwise_the_reference(pools, hedge):
    """benchmarks/serving_hedge.py at low load (rate 0.15, key 5, 20 000
    requests): the port's latencies on the reference's draws equal the
    reference's bit for bit."""
    ref_pool, pool = pools
    rate = np.asarray([0.15], np.float32)
    ref_router = RSV.Router.plan(ref_pool, jnp.asarray(rate), hedge=hedge)
    router = PSV.Router(pool=pool, pi=np.asarray(ref_router.pi), hedge=hedge)
    sampler = lambda k, s: jax.random.exponential(k, s + (6,)) / jnp.asarray(MU)
    key = jax.random.key(5)
    want, want_cid = RSV.simulate_serving(key, ref_router, jnp.asarray(rate), sampler)
    got, cid = PSV.simulate_serving(None, router, rate, draws=_serving_draws(key, rate, 20000))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cid, want_cid)
    assert got.shape == (18000,)


def test_simulate_serving_hedging_cuts_the_tail_at_low_load(pools):
    """tests/test_serving.py's claim on the port's own generator path."""
    _, pool = pools
    rates = np.asarray([0.1], np.float32)
    mu = torch.tensor(MU)
    sampler = lambda g, s: torch.empty(s + (6,)).exponential_(generator=g) / mu
    lat = {}
    for hedge in (0, 1):
        router = PSV.Router.plan(pool, rates, hedge=hedge)
        lat[hedge], _ = PSV.simulate_serving(torch.Generator().manual_seed(1), router, rates,
                                             sampler, n_requests=6000)
    assert np.quantile(lat[1], 0.99) < np.quantile(lat[0], 0.99)
    assert lat[1].mean() < lat[0].mean()
    with pytest.raises(ValueError, match="Generator"):
        PSV.simulate_serving(None, router, rates, sampler)
