"""The port's plan -> Madow dispatch -> FCFS simulation path against the
reference, end to end on the CPU.

* ``solve`` on the quickstart problem and on the §V.B catalog cut to
  r = 64 files: identical n_i and placement, pi within atol 1e-3,
  ``objective`` and ``latency_tight`` within rtol 1e-3. The two solvers
  take the same steps, but float32 sums in another order make tiny
  differences that the backtracking line search may amplify; these are
  the tolerances ``tests/test_jlcm_batch.py`` holds the reference's own
  solver paths to.
* ``simulate`` and ``simulate_fleet`` fed the reference's own draws,
  rebuilt from its key with its own splits: equal latencies. The Madow
  masks come from a float32 cumsum that XLA and PyTorch round differently
  in the last bit, so a uniform that lands within an ulp of a segment
  boundary could flip one mask; the tests count such flips (0 at these
  seeds) and compare latencies exactly up to the first flip.
* ``simulate_fleet`` with the port's own generator, statistically: pooled
  mean latency and node-busy shares within 5% of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.storage.simulator as ref_sim
from benchmarks.common import paper_catalog
from repro.core import JLCMProblem as RefProblem
from repro.core import solve as ref_solve
from repro.core.scheduling import madow_sample as ref_madow
from repro.storage import GeoFabric as RefGeoFabric
from repro.storage import tahoe_testbed as ref_testbed
from repro_torch.core import JLCMProblem, solve
from repro_torch.core.scheduling import madow_sample
from repro_torch.storage import (
    GeoFabric,
    SimDraws,
    generate_geo_workload,
    generate_workload,
    simulate,
    simulate_fleet,
    tahoe_testbed,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _quickstart():
    ks = np.array([6.0, 7.0, 4.0], np.float32)
    lam = np.full(3, 0.125 / 3, np.float32)
    return lam, ks, float(np.mean(200.0 / ks))


def _catalog(r):
    lam, ks, chunk = paper_catalog(r=r)
    lam = np.asarray(lam)  # float32, as the reference holds it
    return lam, np.asarray(ks), chunk, float(np.average(chunk, weights=lam))


def _solve_both(lam, ks, chunk_mb, theta, **kw):
    ref_cl, cl = ref_testbed(), tahoe_testbed(device="cpu")
    ref = ref_solve(
        RefProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                   moments=ref_cl.moments(chunk_mb), cost=ref_cl.cost,
                   theta=theta),
        **kw,
    )
    port = solve(
        JLCMProblem(lam=_t(lam), k=_t(ks), moments=cl.moments(chunk_mb),
                    cost=cl.cost, theta=theta),
        **kw,
    )
    return ref, port


def _assert_same_plan(ref, port):
    np.testing.assert_array_equal(port.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(port.placement.numpy(), np.asarray(ref.placement))
    np.testing.assert_allclose(port.pi.numpy(), np.asarray(ref.pi), atol=1e-3)
    for name in ("objective", "latency_tight", "latency"):
        np.testing.assert_allclose(
            float(getattr(port, name)), float(getattr(ref, name)), rtol=1e-3
        )
    # same placement; the float32 sum over r x m prices runs in another order
    np.testing.assert_allclose(float(port.cost), float(ref.cost), rtol=1e-5)
    tr = port.objective_trace.numpy()
    assert tr.shape == (int(port.iterations) + 1,)
    assert (np.diff(tr) <= 0).all()  # backtracking never accepts a rise


@pytest.mark.parametrize("theta", [0.5, 200.0])
def test_quickstart_plan_matches_and_bounds_the_simulation(theta):
    lam, ks, chunk = _quickstart()
    ref, port = _solve_both(lam, ks, chunk, theta, max_iters=300)
    _assert_same_plan(ref, port)
    # the claim examples/quickstart.py asserts, on the port's own run
    cl = tahoe_testbed(device="cpu")
    sim = simulate(torch.Generator().manual_seed(0), port.pi, _t(lam), cl, chunk, 20000)
    assert float(sim.mean_latency()) <= float(port.latency_tight) * 1.05


@pytest.mark.parametrize("load", [1.0, 1000 / 64])
def test_catalog_plan_matches(load):
    """fig8's settings (theta = 2, eps = 0.01) on the catalog cut to r = 64,
    at the paper's per-file rates and at its r = 1000 aggregate load."""
    lam, ks, _, eff = _catalog(64)
    ref, port = _solve_both(lam * np.float32(load), ks, eff, 2.0, eps=0.01)
    _assert_same_plan(ref, port)
    assert int(port.iterations) == int(ref.iterations)


# ---------------------------------------------------------------- simulate


def _ref_draws(key, lam_cs, n, m, geo=False):
    """The reference's draws for one system, with its own key splits:
    `simulate` (Gumbel file marks) or, with ``geo``, `_fleet_inputs`
    (inverse-CDF (site, file) marks)."""
    k_wl, k_sel, k_srv = jax.random.split(key, 3)
    if geo:
        t, fid, sid = ref_sim.generate_geo_workload(k_wl, jnp.asarray(lam_cs), n)
    else:
        t, fid = ref_sim.generate_workload(k_wl, jnp.asarray(lam_cs[0]), n)
        sid = jnp.zeros_like(fid)
    # scheduling.py draws u exactly so, once per request key
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(
        jax.random.split(k_sel, n)
    )
    e = jax.random.exponential(k_srv, (n, m))
    return t, fid, u, e, sid


def _port_draws(draws):
    t, fid, u, e, sid = (np.asarray(x) for x in draws)
    return SimDraws(
        _t(t), _t(fid, torch.int64), _t(u), _t(e), _t(sid, torch.int64)
    )


def _assert_equal_until_first_flip(port_lat, ref_lat, port_masks, ref_masks):
    flips = (port_masks != ref_masks).any(-1)
    assert flips.mean() <= 1e-3, f"{flips.sum()} Madow masks flipped"
    stop = int(np.argmax(flips)) if flips.any() else port_lat.shape[-1]
    np.testing.assert_array_equal(port_lat[..., :stop], ref_lat[..., :stop])
    return int(flips.sum())


def _ref_masks(pi, u, fid):
    """The reference's Madow masks for each request, on explicit uniforms."""
    return np.asarray(jax.vmap(_ref_madow_on_u)(jnp.asarray(u), jnp.asarray(pi)[fid]))


def _ref_madow_on_u(u, pi):
    """The reference's Madow rule on an explicit u (scheduling.py:35-39)."""
    c = jnp.concatenate([jnp.zeros((1,), pi.dtype), jnp.cumsum(pi)])
    return jnp.floor(c[1:] - u) - jnp.floor(c[:-1] - u) >= 1.0


def test_reference_madow_rule_is_what_the_flip_count_uses():
    pi = jnp.asarray(np.random.default_rng(0).random(M) * 0.5, jnp.float32)
    key = jax.random.key(3)
    u = jax.random.uniform(key, (), jnp.float32)
    np.testing.assert_array_equal(ref_madow(key, pi), _ref_madow_on_u(u, pi))


@pytest.mark.parametrize("theta", [0.5, 200.0])
def test_simulate_matches_reference_on_its_draws(theta):
    lam, ks, chunk = _quickstart()
    ref_cl = ref_testbed()
    ref = ref_solve(RefProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                               moments=ref_cl.moments(chunk), cost=ref_cl.cost,
                               theta=theta), max_iters=300)
    pi = np.asarray(ref.pi)
    key, n = jax.random.key(0), 3000
    ref_run = ref_sim.simulate(key, ref.pi, jnp.asarray(lam), ref_cl, chunk, n)
    draws = _ref_draws(key, lam[None], n, M)
    port_run = simulate(
        None, _t(pi), _t(lam), tahoe_testbed(device="cpu"), chunk, n,
        draws=_port_draws(draws),
    )
    warm = n // 10
    masks = madow_sample(_t(draws[2]), _t(pi)[_t(draws[1], torch.int64)])
    _assert_equal_until_first_flip(
        port_run.latency.numpy(), np.asarray(ref_run.latency),
        masks.numpy()[warm:], _ref_masks(pi, draws[2], np.asarray(draws[1]))[warm:],
    )
    np.testing.assert_array_equal(port_run.file_id.numpy(), np.asarray(ref_run.file_id))
    np.testing.assert_array_equal(port_run.arrival.numpy(), np.asarray(ref_run.arrival))
    np.testing.assert_allclose(
        port_run.node_busy.numpy(), np.asarray(ref_run.node_busy), rtol=1e-6
    )


def test_simulate_per_file_chunks_matches_reference():
    """§V.B's heterogeneous chunk sizes (quarters with k = 6, 7, 6, 4)."""
    lam, ks, chunk, eff = _catalog(64)
    ref_cl = ref_testbed()
    ref = ref_solve(RefProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                               moments=ref_cl.moments(eff), cost=ref_cl.cost,
                               theta=2.0), eps=0.01)
    key, n = jax.random.key(3), 2000
    ref_run = ref_sim.simulate(key, ref.pi, jnp.asarray(lam), ref_cl, eff, n,
                               per_file_chunk_mb=jnp.asarray(chunk))
    draws = _ref_draws(key, lam[None], n, M)
    port_run = simulate(
        None, _t(ref.pi), _t(lam), tahoe_testbed(device="cpu"), eff, n,
        per_file_chunk_mb=_t(chunk), draws=_port_draws(draws),
    )
    masks = madow_sample(_t(draws[2]), _t(ref.pi)[_t(draws[1], torch.int64)])
    _assert_equal_until_first_flip(
        port_run.latency.numpy(), np.asarray(ref_run.latency),
        masks.numpy()[n // 10:],
        _ref_masks(np.asarray(ref.pi), draws[2], np.asarray(draws[1]))[n // 10:],
    )
    # per-file means; files 40.. get no requests once ids are restricted
    r = 64
    got = port_run.per_file_mean(r).numpy()
    want = np.asarray(ref_run.per_file_mean(r))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isnan(got).any() == np.isnan(want).any()


def test_per_file_mean_is_nan_for_files_without_requests():
    lam, ks, chunk = _quickstart()
    cl = tahoe_testbed(device="cpu")
    pi = torch.full((3, M), 0.5)
    run = simulate(torch.Generator().manual_seed(1), pi, _t(lam), cl, chunk, 500)
    per_file = run.per_file_mean(5).numpy()  # files 3 and 4 never requested
    assert np.isnan(per_file[3:]).all() and np.isfinite(per_file[:3]).all()
    lat, fid = run.latency.numpy(), run.file_id.numpy()
    np.testing.assert_allclose(per_file[1], lat[fid == 1].mean(), rtol=1e-5)


def test_simulate_refuses_a_tensor_on_another_device():
    cl = tahoe_testbed(device="cpu")
    with pytest.raises(ValueError, match="another|on meta"):
        simulate(torch.Generator(), torch.zeros((3, M), device="meta"),
                 torch.ones(3), cl, 10.0, 100)


# ------------------------------------------------------------------- fleet


def _catalog_plan():
    lam, ks, _, eff = _catalog(64)
    ref_cl = ref_testbed()
    ref = ref_solve(RefProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                               moments=ref_cl.moments(eff), cost=ref_cl.cost,
                               theta=2.0), eps=0.01)
    return lam, eff, np.asarray(ref.pi)


def test_fleet_matches_reference_on_its_draws():
    lam, eff, pi = _catalog_plan()
    lam_cs = lam[None] * np.float32(10.0)  # queues that actually build up
    s, n = 3, 800
    key = jax.random.key(11)
    ref = ref_sim.simulate_fleet(
        key, jnp.asarray(pi), jnp.asarray(lam_cs),
        RefGeoFabric.single_site(ref_testbed()), eff, n, s, devices="never",
    )
    per_seed = [_ref_draws(k, lam_cs, n, M, geo=True) for k in jax.random.split(key, s)]
    draws = _port_draws([np.stack([d[i] for d in per_seed]) for i in range(5)])
    port = simulate_fleet(
        None, _t(pi), _t(lam_cs),
        GeoFabric.single_site(tahoe_testbed(device="cpu")), eff, n, s,
        draws=draws,
    )
    warm = n // 10
    masks = madow_sample(draws.u, _t(pi)[draws.file_id]).numpy()
    for i in range(s):
        _assert_equal_until_first_flip(
            port.latency[i].numpy(), np.asarray(ref.latency[i]),
            masks[i, warm:],
            _ref_masks(pi, per_seed[i][2], np.asarray(per_seed[i][1]))[warm:],
        )
    np.testing.assert_array_equal(port.site_id.numpy(), np.asarray(ref.site_id))
    np.testing.assert_allclose(
        port.node_busy.numpy(), np.asarray(ref.node_busy), rtol=1e-6
    )


def test_fleet_statistics_match_reference():
    lam, eff, pi = _catalog_plan()
    s, n = 8, 4000
    ref = ref_sim.simulate_fleet(
        jax.random.key(0), jnp.asarray(pi), jnp.asarray(lam[None]),
        RefGeoFabric.single_site(ref_testbed()), eff, n, s, devices="never",
    )
    port = simulate_fleet(
        torch.Generator().manual_seed(0), _t(pi), _t(lam[None]),
        GeoFabric.single_site(tahoe_testbed(device="cpu")), eff, n, s,
    )
    assert port.latency.shape == (s, n - n // 10)
    assert port.node_busy.shape == (s, M)
    assert torch.isfinite(port.latency).all()
    np.testing.assert_allclose(
        float(port.mean_latency()), float(ref.mean_latency()), rtol=0.05
    )
    share = port.node_busy.sum(0) / port.node_busy.sum()
    ref_busy = np.asarray(ref.node_busy).sum(0)
    np.testing.assert_allclose(share.numpy(), ref_busy / ref_busy.sum(), rtol=0.05)


# ---------------------------------------------------------------- workload


def test_workload_marks_and_gaps_follow_the_rates():
    lam = torch.tensor([0.05, 0.15, 0.3])
    n = 60000
    t, fid = generate_workload(torch.Generator().manual_seed(2), lam, n)
    assert t.dtype == torch.float32 and fid.dtype == torch.int64
    assert (torch.diff(t) >= 0).all()
    np.testing.assert_allclose(float(t[-1]) / n, 1.0 / float(lam.sum()), rtol=0.02)
    freq = torch.bincount(fid, minlength=3).numpy() / n
    np.testing.assert_allclose(freq, (lam / lam.sum()).numpy(), atol=0.01)


def test_geo_workload_marks_cover_sites_and_files():
    lam_cs = torch.tensor([[0.1, 0.0, 0.1], [0.0, 0.2, 0.0]])
    t, fid, sid = generate_geo_workload(torch.Generator().manual_seed(3), lam_cs, 40000)
    pairs = torch.bincount(sid * 3 + fid, minlength=6).numpy() / 40000
    np.testing.assert_allclose(pairs, (lam_cs / lam_cs.sum()).reshape(-1).numpy(), atol=0.01)
    assert fid.max() < 3 and sid.max() < 2
