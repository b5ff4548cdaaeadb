"""The port's cached and streaming fleets (``simulate_fleet`` with
``cache_ttl``, ``stream=True`` and ``n_chunks``) against the reference, on
the CPU, on the reference's own draws.

* The cached materialized fleet on ``tests/test_cache.py::
  test_fleet_cache_path``'s inputs: latencies equal up to the first flipped
  Madow set, hits bitwise, and the claim (the cached mean below the
  uncached one).
* The streaming fleet at ``n_chunks = 1`` (the seed key used as it is) and
  ``n_chunks = 4`` (the seed key split into four chunk keys), with and
  without the cache, against the reference's ``_fleet_stream_batched``:
  counts and hit counts exact, means within rtol 1e-5, and — with no flip
  — bucket counts, window counts, sketch quantiles and busy time equal.
* ``benchmarks/fleet_scale.py``'s riders on the port alone: a fleet row is
  bitwise ``fleet_one_raw``; streaming at ``n_chunks = 1`` on the
  materialized run's draws has its exact count, its mean within 1e-4 and
  its p99 within the sketch's growth factor above the exact one.
* The reference's three ``ValueError``s, and the accessors that need one
  mode or the other.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.storage as RS
import repro.storage.simulator as ref_sim
import repro_torch.storage as PS
from repro_torch.storage.simulator import SimDraws
from test_torch_segments import flips_of
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
MB = float(2**20)
LAM4 = np.asarray([0.09, 0.07, 0.04, 0.03])  # tests/test_cache.py
GEO_LAM = np.asarray([0.036, 0.028, 0.016, 0.012], np.float32)  # fleet_scale.py
MIX = np.asarray([0.4, 0.25, 0.25, 0.1])
K4 = np.asarray([4.0, 4.0, 6.0, 6.0], np.float32)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_fleet_draws(keys, lam_cs, n, m):
    def one(k):
        k_wl, k_sel, k_srv = jax.random.split(k, 3)
        t, fid, sid = ref_sim.generate_geo_workload(k_wl, lam_cs, n)
        u = jax.vmap(lambda sk: jax.random.uniform(sk, (), jnp.float32))(
            jax.random.split(k_sel, n))
        return t, fid, u, jax.random.exponential(k_srv, (n, m)), sid

    return jax.vmap(one)(keys)


def fleet_draws(keys, lam_cs, n):
    """The reference ``_fleet_inputs``' draws for each key of ``keys``,
    vmapped under jit as the fleet runs them."""
    t, fid, u, e, sid = _jax_fleet_draws(keys, jnp.asarray(lam_cs), n, M)
    return SimDraws(_t(t), _t(fid, torch.int64), _t(u), _t(e), _t(sid, torch.int64))


def chunk_draws(key, lam_cs, block, s, n_chunks):
    """(W, S, N) draws of the streaming fleet: each seed's key used as it
    is for one chunk, else split into ``n_chunks`` chunk keys."""
    keys = jax.random.split(key, s)
    if n_chunks == 1:
        ckeys = keys[:, None]
    else:
        ckeys = jax.vmap(lambda k: jax.random.split(k, n_chunks))(keys)
    per_chunk = [fleet_draws(ckeys[:, w], lam_cs, block) for w in range(n_chunks)]
    return SimDraws(*(None if xs[0] is None else torch.stack(xs) for xs in zip(*per_chunk)))


@pytest.fixture(scope="module")
def fabrics():
    return RS.geo_testbed(), PS.geo_testbed(PS.tahoe_testbed(device="cpu"))


@pytest.fixture(scope="module")
def ttl():
    return RS.CacheModel(file_bytes=np.asarray([50.0, 50.0, 75.0, 75.0]) * MB,
                         capacity_bytes=100.0 * MB, hit_latency=0.5).ttl(LAM4)


def _geo_pi():
    rng = np.random.default_rng(3)
    return np.array(R.project_capped_simplex(
        jnp.asarray(rng.random((4, M)), jnp.float32), jnp.asarray(K4)))


def _rows_equal_until_flip(got, want, flips):
    got, want = got.numpy().reshape(flips.shape), np.asarray(want).reshape(flips.shape)
    for g, w, f in zip(got, want, flips.numpy()):
        stop = int(np.argmax(f)) if f.any() else f.shape[0]
        np.testing.assert_array_equal(g[:stop], w[:stop])


def test_fleet_cache_path_matches_reference(fabrics, ttl):
    ref_fab, fab = fabrics
    lam_cs = np.full((4, 4), 0.02, np.float32)
    pi = np.full((4, M), 4.0 / M, np.float32)
    key, n, s = jax.random.key(0), 400, 4
    kw = dict(devices="never")
    cold = ref_sim.simulate_fleet(key, jnp.asarray(pi), jnp.asarray(lam_cs), ref_fab, 12.5, n,
                                  s, **kw)
    warm = ref_sim.simulate_fleet(key, jnp.asarray(pi), jnp.asarray(lam_cs), ref_fab, 12.5, n,
                                  s, cache_ttl=ttl, cache_hit_latency=0.5, **kw)
    draws = fleet_draws(jax.random.split(key, s), lam_cs, n)
    got_cold = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, n, s, draws=draws)
    got_warm = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, n, s, cache_ttl=ttl,
                                 cache_hit_latency=0.5, draws=draws)
    assert got_cold.hit is None and cold.hit is None
    np.testing.assert_array_equal(got_warm.hit.numpy(), np.asarray(warm.hit))
    np.testing.assert_array_equal(got_warm.file_id.numpy(), np.asarray(warm.file_id))
    flips = flips_of(draws, pi)[:, n // 10:]
    assert flips.float().mean() <= 1e-3
    for got, want in ((got_cold, cold), (got_warm, warm)):
        _rows_equal_until_flip(got.latency, want.latency, flips)
    hit = got_warm.hit.numpy()
    assert hit.any()
    np.testing.assert_array_equal(got_warm.latency.numpy()[hit], np.float32(0.5))
    assert float(got_warm.mean_latency()) < float(got_cold.mean_latency())


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_streaming_fleet_matches_reference(fabrics, ttl, n_chunks, cached):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    lam_cs = (MIX[:, None] * GEO_LAM[None, :]).astype(np.float32)
    key, s, block = jax.random.key(5), 3, 300
    warm = int(block * n_chunks * 0.1)
    d, rates = ref_fab.service_params(12.5)
    sketch = RS.DEFAULT_SKETCH
    want_stats, want_windows, want_busy, want_hits, want_lat = ref_sim._fleet_stream_batched(
        jax.random.split(key, s), jnp.asarray(pi), jnp.asarray(lam_cs), d, rates,
        jnp.asarray(ttl, jnp.float32) if cached else jnp.zeros((1,), jnp.float32),
        jnp.float32(0.5), n_chunks, block, warm, sketch, cached=cached, materialize=True)
    draws = chunk_draws(key, lam_cs, block, s, n_chunks)
    got = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, block, s, stream=True,
                            n_chunks=n_chunks, cache_ttl=ttl if cached else None,
                            cache_hit_latency=0.5, keep_latency=True, draws=draws)
    assert got.file_id is None and got.site_id is None and got.hit is None
    assert got.windows.count.shape == (s, n_chunks)
    np.testing.assert_array_equal(got.stream.count.numpy(), np.asarray(want_stats.count))
    np.testing.assert_array_equal(got.windows.count.numpy(), np.asarray(want_windows.count))
    np.testing.assert_allclose(got.stream.mean.numpy(), np.asarray(want_stats.mean), rtol=1e-5)
    if cached:
        np.testing.assert_array_equal(got.hit_count.numpy(), np.asarray(want_hits))
        assert int(got.hit_count.sum()) > 0
    else:
        assert got.hit_count is None
    flips = torch.cat([flips_of(draws.at(w), pi) for w in range(n_chunks)], dim=1)
    assert flips.float().mean() <= 1e-3
    _rows_equal_until_flip(got.latency, want_lat, flips)
    if not flips.any():
        np.testing.assert_array_equal(got.stream.hist.numpy(), np.asarray(want_stats.hist))
        np.testing.assert_array_equal(got.windows.hist.numpy(), np.asarray(want_windows.hist))
        np.testing.assert_allclose(got.node_busy.numpy(), np.asarray(want_busy), rtol=1e-6)
        want_res = ref_sim.FleetResult(None, None, None, want_busy, stream=want_stats,
                                       windows=want_windows, sketch=sketch)
        assert float(got.quantile(0.99)) == float(want_res.quantile(0.99))
        np.testing.assert_allclose(float(got.p99_windowed()), float(want_res.p99_windowed()),
                                   rtol=1e-6)


def test_fleet_scale_riders_on_the_port(fabrics):
    fab = fabrics[1]
    pi = _t(_geo_pi())
    lam_cs = _t(MIX[:, None] * GEO_LAM[None, :])
    s, n = 4, 1000
    draws = PS.simulator._draw(torch.Generator().manual_seed(2), lam_cs, (s, n), M)
    fleet = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, n, s, draws=draws)
    # rider 1: a fleet row is the single-seed path on the same draws
    d, rates = fab.service_params(12.5)
    one = PS.fleet_one_raw(None, pi, lam_cs, d, rates, n, n // 10, draws=draws.at(0))
    assert torch.equal(one[0], fleet.latency[0]) and one[4] is None
    # rider 2: streaming at n_chunks = 1 on the same draws
    stream = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, n, s, stream=True, draws=draws)
    lat = fleet.latency.numpy()
    assert int(stream.stream.count.sum()) == lat.size
    mat_mean, str_mean = float(lat.mean()), float(stream.mean_latency())
    assert abs(str_mean - mat_mean) <= 1e-4 * abs(mat_mean) + 1e-7
    exact = float(np.quantile(lat, 0.99, method="inverted_cdf"))
    sketch_p99 = float(stream.quantile(0.99))
    assert exact <= sketch_p99 * (1 + 1e-6)
    assert sketch_p99 <= exact * stream.sketch.growth * (1 + 1e-6)


def test_streaming_fleet_on_the_generator(fabrics, ttl):
    fab = fabrics[1]
    lam_cs = _t(MIX[:, None] * GEO_LAM[None, :] * 2.0)
    res = PS.simulate_fleet(torch.Generator().manual_seed(0), _geo_pi(), lam_cs, fab, 12.5,
                            250, 2, stream=True, n_chunks=3, cache_ttl=ttl,
                            cache_hit_latency=0.5)
    assert res.latency is None and res.windows.count.shape == (2, 3)
    assert int(res.stream.count.sum()) == 2 * (750 - 75)
    assert int(res.hit_count.sum()) > 0
    assert np.isfinite(float(res.quantile(0.99))) and np.isfinite(float(res.p99_windowed()))
    assert float(res.p99_windowed()) >= 0.5


def test_fleet_raises_like_the_reference(fabrics):
    fab = fabrics[1]
    pi, lam_cs = _t(_geo_pi()), _t(MIX[:, None] * GEO_LAM[None, :])
    gen = torch.Generator()
    for kw, match in ((dict(n_chunks=0), "n_chunks must be >= 1"),
                      (dict(n_chunks=2), "require stream=True"),
                      (dict(keep_latency=True), "keep_latency")):
        with pytest.raises(ValueError, match=match):
            PS.simulate_fleet(gen, pi, lam_cs, fab, 12.5, 10, 2, **kw)
    mat = PS.simulate_fleet(gen, pi, lam_cs, fab, 12.5, 50, 2)
    with pytest.raises(ValueError, match="streaming run"):
        mat.quantile(0.99)
    with pytest.raises(ValueError, match="streaming run"):
        mat.p99_windowed()
    streamed = PS.simulate_fleet(gen, pi, lam_cs, fab, 12.5, 50, 2, stream=True)
    with pytest.raises(ValueError, match="materialized run"):
        streamed.per_site_mean(4)
