"""The port's geo client fabric (``core/geo.py`` and the geo parts of
``storage/cluster.py``) against the reference, on the CPU.

* The fabric: ``geo_testbed``'s (C, m) overheads and bandwidths equal the
  reference's bit for bit, its moments within rtol 1e-5 (float32 powers);
  the one-site fabric's moments are the cluster's, bit for bit.
* The moments and folds (``pair_moments``, ``node_mixture_moments``,
  ``geo_eq_varq``, ``geo_shared_z_latency``, ``geo_optimal_shared_z``)
  agree within rtol 1e-5 at the same pi.
* ``geo_problem`` with one site collapses to the plain problem and solves
  bit for bit as it; C identical sites match the plain path.
* Solves hold ``tests/test_torch_slice.py``'s tolerances: identical ``n``
  and ``placement``, ``objective`` and ``latency_tight`` within rtol 1e-3,
  pi within atol 1e-3, or, where the reference's own merged and debug
  modes stop further apart (the TX-anchored mix stops in a flat valley,
  ``ROADMAP.md`` §C), within that spread.
* ``benchmarks/fleet_scale.py``'s four files planned as a geo problem and
  simulated by ``simulate_fleet`` on the reference's own draws: latencies
  equal up to the first flipped Madow mask, per-site means within rtol
  1e-5, EU above the reference site, and the mean within the bound x 1.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.storage as RS
import repro_torch.core as P
import repro_torch.storage as PS
from repro_torch.core.scheduling import madow_sample
from test_torch_slice import _port_draws, _ref_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
LAM = np.asarray([0.036, 0.028, 0.016, 0.012], np.float32)  # fleet_scale.py
K = np.asarray([4.0, 4.0, 6.0, 6.0], np.float32)
MIX = np.asarray([0.4, 0.25, 0.25, 0.1])  # client share by site
CHUNK_MB = 12.5
CATALOG_CHUNKS = (150.0 / 6, 150.0 / 7, 150.0 / 4, 12.5)
NJ_MIX = np.tile([0.9, 0.04, 0.03, 0.03], (4, 1))
TX_MIX = np.tile([0.04, 0.9, 0.03, 0.03], (4, 1))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(port, ref, rtol=1e-5, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, **kw)


@pytest.fixture(scope="module")
def fabrics():
    return RS.geo_testbed(), PS.geo_testbed(PS.tahoe_testbed(device="cpu"))


def _pi(seed=0, r=4):
    rng = np.random.default_rng(seed)
    return np.array(R.project_capped_simplex(
        jnp.asarray(rng.random((r, M)), jnp.float32), jnp.asarray(K[:r])))


# ------------------------------------------------------------------ fabric


def test_geo_testbed_matches_reference(fabrics):
    ref, port = fabrics
    assert port.site_names == ref.site_names == ("NJ", "TX", "CA", "EU")
    assert port.n_sites == 4 and port.site_index("EU") == ref.site_index("EU") == 3
    np.testing.assert_array_equal(port.overheads().numpy(), np.asarray(ref.overheads()))
    np.testing.assert_array_equal(port.bandwidths().numpy(), np.asarray(ref.bandwidths()))
    np.testing.assert_array_equal(port.uniform_mix(5), ref.uniform_mix(5))
    for chunk in CATALOG_CHUNKS:
        for a, b in zip(port.moments(chunk), ref.moments(chunk)):
            assert a.shape == (4, M)
            _close(a, b)
    # row 0 (NJ) is the paper's own client; co-located clients see their
    # own site faster than NJ does
    ovh = port.overheads().numpy()
    np.testing.assert_array_equal(ovh[0], port.cluster.overheads().numpy())
    assert (ovh[1, 4:8] < ovh[0, 4:8]).all() and (ovh[2, 8:12] < ovh[0, 8:12]).all()


def test_single_site_moments_are_the_cluster_moments_bitwise(fabrics):
    cluster = fabrics[1].cluster
    deg = PS.GeoFabric.single_site(cluster)
    assert deg.n_sites == 1
    for chunk in CATALOG_CHUNKS:
        for g, w in zip(deg.moments(chunk), cluster.moments(chunk)):
            assert torch.equal(g[0], w)


# ----------------------------------------------------------------- moments


def _specs(fabrics, mix):
    ref, port = fabrics
    return (R.make_geo(ref.moments(CHUNK_MB), mix), P.make_geo(port.moments(CHUNK_MB), mix))


@pytest.mark.parametrize("mix", ["uniform", "dirichlet"])
def test_pair_and_node_moments_match(mix, fabrics):
    m = fabrics[0].uniform_mix(4) if mix == "uniform" else np.random.default_rng(1).dirichlet(
        np.ones(4), 4)
    rgeo, pgeo = _specs(fabrics, m)
    for a, b in zip(P.pair_moments(pgeo), R.pair_moments(rgeo)):
        _close(a, b)
    rn, pn = R.node_mixture_moments(jnp.asarray(LAM), rgeo), P.node_mixture_moments(_t(LAM), pgeo)
    for a, b in zip(pn, rn):
        assert a.shape == (M,)
        _close(a, b)
    pn.validate()  # mixtures are valid distributions
    pi = _pi(2)
    for a, b in zip(P.geo_eq_varq(_t(pi), _t(LAM), pgeo),
                    R.geo_eq_varq(jnp.asarray(pi), jnp.asarray(LAM), rgeo)):
        assert a.shape == (4, M)
        _close(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_geo_shared_z_latency_and_its_z_match(weighted, fabrics):
    rgeo, pgeo = _specs(fabrics, np.random.default_rng(3).dirichlet(np.ones(4), 4))
    pi = _pi(4)
    w = np.asarray([3.0, 3.0, 1.0, 1.0], np.float32) if weighted else None
    rkw = {} if w is None else {"weights": jnp.asarray(w)}
    pkw = {} if w is None else {"weights": _t(w)}
    z_ref = R.geo_optimal_shared_z(jnp.asarray(pi), jnp.asarray(LAM), rgeo, **rkw)
    z = P.geo_optimal_shared_z(_t(pi), _t(LAM), pgeo, **pkw)
    _close(z, z_ref, rtol=1e-4)
    for zz in (z_ref, 5.0):
        _close(P.geo_shared_z_latency(_t(pi), _t(zz), _t(LAM), pgeo, **pkw),
               R.geo_shared_z_latency(jnp.asarray(pi), jnp.asarray(zz), jnp.asarray(LAM),
                                      rgeo, **rkw))


def test_identical_sites_fold_as_the_plain_path(fabrics):
    cluster = fabrics[1].cluster
    mom = cluster.moments(CHUNK_MB)
    site = P.ServiceMoments(*(x.expand(4, M) for x in mom))
    gprob = P.geo_problem(LAM, K, site, np.full((4, 4), 0.25), cluster.cost, 2.0)
    assert gprob.geo is not None
    pi = P.feasible_uniform(torch.ones((4, M), dtype=torch.bool), _t(K))
    z = torch.tensor(5.0)
    np.testing.assert_allclose(
        float(P.geo_shared_z_latency(pi, z, _t(LAM), gprob.geo)),
        float(P.shared_z_latency(pi, z, _t(LAM), mom)), rtol=1e-6)


# ------------------------------------------------------------------ solver


def test_degenerate_problem_collapses_and_solves_bit_for_bit(fabrics):
    cluster = fabrics[1].cluster
    mom = cluster.moments(CHUNK_MB)
    plain = P.JLCMProblem(lam=_t(LAM), k=_t(K), moments=mom, cost=cluster.cost, theta=2.0)
    site = P.ServiceMoments(*(x[None] for x in mom))
    gprob = P.geo_problem(LAM, K, site, np.ones((4, 1)), cluster.cost, 2.0)
    assert gprob.geo is None  # C == 1 collapses to the plain path
    sol, gsol = P.solve(plain, max_iters=150), P.solve(gprob, max_iters=150)
    for name in ("pi", "objective", "latency_tight", "objective_trace"):
        assert torch.equal(getattr(gsol, name), getattr(sol, name)), name
    spec = P.make_objective([0, 0, 1, 1], (2.0, 1.0), device="cpu")
    assert P.geo_problem(LAM, K, site, np.ones((4, 1)), cluster.cost, 2.0,
                         objective=spec).objective is spec


def test_geo_problem_validates_like_the_reference(fabrics):
    ref, port = fabrics
    for mix in (np.ones(4), np.ones((3, 4))):
        with pytest.raises(ValueError) as ref_err:
            R.geo_problem(LAM, K, ref.moments(CHUNK_MB), mix, ref.cluster.cost, 2.0)
        with pytest.raises(ValueError) as err:
            P.geo_problem(LAM, K, port.moments(CHUNK_MB), mix, port.cluster.cost, 2.0)
        assert str(err.value) == str(ref_err.value)


def _geo_pair(fabrics, mix):
    ref, port = fabrics
    return (R.geo_problem(LAM, K, ref.moments(CHUNK_MB), mix, ref.cluster.cost, 2.0),
            P.geo_problem(LAM, K, port.moments(CHUNK_MB), mix, port.cluster.cost, 2.0))


def _assert_same_plan(got, want, pi_atol=1e-3):
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    np.testing.assert_array_equal(got.placement.numpy(), np.asarray(want.placement))
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi), atol=pi_atol)
    for name in ("objective", "latency_tight", "latency"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-3)
    _close(got.cost, want.cost)


def test_fleet_scale_geo_solve_matches_reference(fabrics):
    ref, port = _geo_pair(fabrics, np.tile(MIX, (4, 1)))
    want, got = R.solve(ref, max_iters=300), P.solve(port, max_iters=300)
    _assert_same_plan(got, want)
    assert int(got.iterations) == int(want.iterations)


@pytest.fixture(scope="module")
def mix_batch(fabrics):
    """7c's two client mixes (NJ- and TX-anchored) as one batch, and, for
    each, the reference's own runs: its batch row, its single merged solve
    and its debug mode."""
    pairs = [_geo_pair(fabrics, mix) for mix in (NJ_MIX, TX_MIX)]
    ref = R.solve_batch([p[0] for p in pairs], max_iters=150)
    port = P.solve_batch([p[1] for p in pairs], max_iters=150)
    ref_runs = [[np.asarray(ref.pi[i]), np.asarray(R.solve(p[0], max_iters=150).pi),
                 np.asarray(R.solve(p[0], max_iters=150, mode="debug").pi)]
                for i, p in enumerate(pairs)]
    return pairs, ref, port, ref_runs


def test_client_mix_batch_matches_reference(mix_batch):
    """Where the objective is flat, a last-bit difference moves pi further
    than 1e-3: on the TX-anchored mix the reference's single solve stops
    4.4e-3 from its own batch row and debug run (``ROADMAP.md`` §C). pi is
    held within 1e-3 or the spread of the reference's own runs."""
    _, ref, port, ref_runs = mix_batch
    for i in range(2):
        want = type(ref)(*(None if f is None else f[i] for f in ref))
        got = type(port)(*(None if f is None else f[i] for f in port))
        spread = max(float(np.abs(a - b).max()) for a in ref_runs[i] for b in ref_runs[i])
        _assert_same_plan(got, want, pi_atol=max(1e-3, spread))
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))


def test_placement_follows_the_client_mix(mix_batch):
    port = mix_batch[2]
    mass_nj, mass_tx = (float(port.pi[i][:, 4:8].sum()) for i in range(2))
    assert mass_tx > mass_nj + 0.5, (mass_nj, mass_tx)


def test_mix_batch_instances_equal_single_solves(mix_batch):
    pairs, _, port, _ = mix_batch
    for i, (_, prob) in enumerate(pairs):
        single = P.solve(prob, max_iters=150)
        np.testing.assert_allclose(port.pi[i].numpy(), single.pi.numpy(), atol=2e-5)


def test_stacking_mixed_geo_and_geo_with_background_rejected(fabrics):
    _, gp = _geo_pair(fabrics, fabrics[1].uniform_mix(4))
    cl = fabrics[1].cluster
    plain = P.JLCMProblem(lam=_t(LAM), k=_t(K), moments=cl.moments(CHUNK_MB), cost=cl.cost,
                          theta=2.0)
    with pytest.raises(ValueError, match="geo"):
        P.solve_batch([gp, plain])
    _, three = _geo_pair(fabrics, np.full((4, 4), 0.25))
    three = three._replace(geo=three.geo._replace(mix=three.geo.mix[:, :3],
                                                  m1=three.geo.m1[:3], m2=three.geo.m2[:3],
                                                  m3=three.geo.m3[:3]))
    with pytest.raises(ValueError, match="geo"):
        P.stack_problems([gp, three])
    with pytest.raises(ValueError, match="background"):
        P.solve(gp._replace(background=torch.zeros(M)))


# ------------------------------------------------------------------- fleet


def _ref_fleet_draws(key, lam_cs, n, s):
    """The reference ``simulate_fleet``'s draws for ``s`` seeds, with its own
    key splits."""
    per_seed = [_ref_draws(k, lam_cs, n, M, geo=True) for k in jax.random.split(key, s)]
    return _port_draws([np.stack([np.asarray(d[i]) for d in per_seed]) for i in range(5)])


def test_geo_fleet_on_the_reference_draws(fabrics):
    ref_fab, fab = fabrics
    ref_prob, prob = _geo_pair(fabrics, np.tile(MIX, (4, 1)))
    want_sol, sol = R.solve(ref_prob, max_iters=300), P.solve(prob, max_iters=300)
    lam_cs = (MIX[:, None] * LAM[None, :]).astype(np.float32)  # (C, r)
    key, s, n = jax.random.key(0), 3, 3000
    want = RS.simulate_fleet(key, want_sol.pi, jnp.asarray(lam_cs), ref_fab, CHUNK_MB, n, s,
                             devices="never")
    draws = _ref_fleet_draws(key, lam_cs, n, s)
    got = PS.simulate_fleet(None, sol.pi, _t(lam_cs), fab, CHUNK_MB, n, s, draws=draws)
    warm = n // 10
    flips = (madow_sample(draws.u, sol.pi[draws.file_id])
             != madow_sample(draws.u, _t(want_sol.pi)[draws.file_id])).any(-1)[:, warm:]
    assert flips.float().mean() <= 1e-3
    np.testing.assert_array_equal(got.site_id.numpy(), np.asarray(want.site_id))
    for i in range(s):
        stop = int(np.argmax(flips[i].numpy())) if flips[i].any() else n - warm
        np.testing.assert_array_equal(got.latency[i, :stop].numpy(),
                                      np.asarray(want.latency[i, :stop]))
    per_site = got.per_site_mean(4)
    if not flips.any():
        _close(per_site, want.per_site_mean(4))
    # fleet_scale's geo claims: the remote site pays more, the bound holds
    assert per_site[ref_fab.site_index("EU")] > per_site[0]
    assert float(got.mean_latency()) <= 1.05 * float(sol.latency_tight)


def test_per_site_mean_is_nan_for_silent_sites(fabrics):
    fab = fabrics[1]
    pi = P.feasible_uniform(torch.ones((4, M), dtype=torch.bool), _t(K))
    lam_cs = torch.zeros((4, 4))
    lam_cs[0] = _t(LAM)  # only site 0 originates requests
    res = PS.simulate_fleet(torch.Generator().manual_seed(0), pi, lam_cs, fab, CHUNK_MB, 500, 2)
    per_site = res.per_site_mean(4).numpy()
    assert np.isfinite(per_site[0]) and np.isnan(per_site[1:]).all()
    np.testing.assert_allclose(per_site[0], res.latency.numpy().mean(), rtol=1e-5)
