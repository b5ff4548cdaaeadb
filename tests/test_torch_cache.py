"""The port's hot-tier cache (``storage/cache.py``) against the reference,
on the CPU.

* The Che model and ``CacheModel`` (host float64 numpy, copied from the
  reference) bit for bit on ``tests/test_cache.py``'s fixtures: the
  characteristic time, TTLs and hit rates with and without admission
  control, thinning, the miss-to-raw inversion on both branches, the hot
  cost, and ``spec`` (the solver's ``CacheSpec``, float32).
* ``ttl_cache_scan``, which the port computes from one stable sort on file
  id instead of a scan over requests: hits and new expiries bitwise equal
  to the reference's ``lax.scan`` on 200 random streams with carried
  expiries (cold, warm, ``inf``) and zero TTLs, one system at a time and
  batched over seeds, and on ``test_ttl_scan_zero_ttl_never_hits``'s
  inputs.
* ``simulate_ttl_cache`` on the reference's own draws: the same per-file
  hit and request counts; on the port's own generator the hit rates match
  the Che prediction (``test_empirical_hit_rates_match_che``'s claim).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.storage.cache as ref_cache
import repro_torch.storage.cache as cache
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MB = float(2**20)
LAM = np.asarray([0.09, 0.07, 0.04, 0.03])
MODEL_KW = dict(file_bytes=np.asarray([50.0, 50.0, 75.0, 75.0]) * MB,
                capacity_bytes=100.0 * MB, hit_latency=0.5, hot_price_per_mb=0.02)


@pytest.fixture(scope="module", params=[0.0, 0.35], ids=["lru", "admission"])
def models(request):
    kw = dict(MODEL_KW, admit_min_hit=request.param)
    return ref_cache.CacheModel(**kw), cache.CacheModel(**kw)


def test_constants_match():
    assert cache.HOT_REPLICATION == ref_cache.HOT_REPLICATION
    assert cache.WARM_OVERHEAD == ref_cache.WARM_OVERHEAD
    assert cache.MB == ref_cache.MB


@pytest.mark.parametrize("capacity_mb", [0.0, 25.0, 100.0, 249.0, 251.0])
def test_che_characteristic_time_and_hit_rates_bitwise(capacity_mb):
    size = MODEL_KW["file_bytes"]
    want = ref_cache.che_characteristic_time(LAM, size, capacity_mb * MB)
    got = cache.che_characteristic_time(LAM, size, capacity_mb * MB)
    assert got == want or (np.isinf(got) and np.isinf(want))
    ttl = np.full(4, got)
    np.testing.assert_array_equal(cache.che_hit_rates(LAM, ttl),
                                  ref_cache.che_hit_rates(LAM, ttl))
    np.testing.assert_array_equal(cache.che_hit_rates(np.r_[LAM[:3], 0.0], got),
                                  ref_cache.che_hit_rates(np.r_[LAM[:3], 0.0], got))


def test_cache_model_bitwise(models):
    ref, port = models
    for name in ("admitted", "ttl", "hit_rates", "thin"):
        np.testing.assert_array_equal(getattr(port, name)(LAM), getattr(ref, name)(LAM))
    assert port.expected_hot_bytes(LAM) == ref.expected_hot_bytes(LAM)
    assert port.hot_cost() == ref.hot_cost()
    assert port.r == ref.r == 4
    ttl = ref.ttl(LAM)
    miss = LAM * np.exp(-LAM * ttl)
    hot = np.full(4, 0.5)
    cases = [
        dict(miss_rates=miss, ttl=ttl, prior=LAM),
        dict(miss_rates=miss * 0.98, ttl=ttl, prior=LAM),
        dict(miss_rates=miss, ttl=ttl),
        dict(miss_rates=hot * np.exp(-hot * 10.0), ttl=np.full(4, 10.0), prior=hot),
        dict(miss_rates=hot * np.exp(-hot * 10.0), ttl=np.full(4, 10.0), prior=0.01 * hot),
        dict(miss_rates=np.r_[miss[:2], 0.5, 0.0], ttl=np.r_[0.0, np.inf, 10.0, 5.0],
             prior=LAM),
        dict(miss_rates=miss, ttl=ttl, prior=LAM, cache_up=False),
    ]
    for kw in cases:
        np.testing.assert_array_equal(port.reconstruct_raw_rates(**kw),
                                      ref.reconstruct_raw_rates(**kw))


def test_cache_spec_matches(models):
    ref, port = models
    for extra in (0, 3):
        want = ref.spec(LAM, extra_rows=extra)
        got = port.spec(LAM, extra_rows=extra, device="cpu")
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
        assert float(got.hit_latency) == float(want.hit_latency)
        assert float(got.hot_cost) == float(want.hot_cost)
    assert (got.hit[-3:] == 0).all()


def test_cache_model_validates_like_the_reference():
    bad = [dict(file_bytes=np.asarray([1.0, -1.0])), dict(capacity_bytes=-1.0),
           dict(hit_latency=-0.1), dict(admit_min_hit=1.0)]
    for change in bad:
        kw = dict(MODEL_KW, **change)
        with pytest.raises(ValueError):
            ref_cache.CacheModel(**kw)
        with pytest.raises(ValueError):
            cache.CacheModel(**kw)
    with pytest.raises(ValueError, match="lam must be"):
        cache.CacheModel(**MODEL_KW).ttl(LAM[:3])
    assert dataclasses.replace(cache.CacheModel(**MODEL_KW), capacity_bytes=0.0).hot_cost() == 0


# ------------------------------------------------------------ ttl_cache_scan


def _random_stream(rng):
    # a few shapes, so the reference's scan compiles a few times only
    r, n = int(rng.choice([1, 3, 8])), int(rng.choice([1, 2, 41, 79]))
    t = (np.cumsum(rng.exponential(1.0, n)) + rng.uniform(0.0, 5.0)).astype(np.float32)
    fid = rng.integers(0, r, n)
    ttl = rng.exponential(2.0, r).astype(np.float32)
    ttl[rng.random(r) < 0.3] = 0.0
    expiry = np.where(rng.random(r) < 0.5, -np.inf, rng.uniform(0.0, 10.0, r))
    expiry[rng.random(r) < 0.1] = np.inf
    return expiry.astype(np.float32), t, fid, ttl


# under jit the scan compiles once a shape, not once a call
_ref_scan_jit = jax.jit(ref_cache.ttl_cache_scan)


def _ref_scan(expiry, t, fid, ttl):
    e, h = _ref_scan_jit(jnp.asarray(expiry), jnp.asarray(t), jnp.asarray(fid), jnp.asarray(ttl))
    return np.asarray(e), np.asarray(h)


def _port_scan(expiry, t, fid, ttl):
    e, h = cache.ttl_cache_scan(torch.as_tensor(expiry), torch.as_tensor(t),
                                torch.as_tensor(fid, dtype=torch.int64), torch.as_tensor(ttl))
    return e.numpy(), h.numpy()


def test_ttl_cache_scan_bitwise_on_200_random_streams():
    rng = np.random.default_rng(0)
    for _ in range(200):
        stream = _random_stream(rng)
        want, got = _ref_scan(*stream), _port_scan(*stream)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("shared_ttl", [True, False])
def test_ttl_cache_scan_batched_over_seeds_bitwise(shared_ttl):
    rng = np.random.default_rng(1)
    s, r, n = 16, 6, 120
    t = (np.cumsum(rng.exponential(0.5, (s, n)), axis=1)).astype(np.float32)
    fid = rng.integers(0, r, (s, n))
    ttl = rng.exponential(3.0, (s, r)).astype(np.float32)
    ttl[:, 1] = 0.0
    if shared_ttl:
        ttl = ttl[0]
    expiry = np.where(rng.random((s, r)) < 0.5, -np.inf, rng.uniform(0, 5, (s, r)))
    expiry = expiry.astype(np.float32)
    got_e, got_h = _port_scan(expiry, t, fid, ttl)
    for i in range(s):
        want_e, want_h = _ref_scan(expiry[i], t[i], fid[i], ttl if shared_ttl else ttl[i])
        np.testing.assert_array_equal(got_e[i], want_e)
        np.testing.assert_array_equal(got_h[i], want_h)


def test_ttl_scan_zero_ttl_never_hits():
    """tests/test_cache.py's scan-level invalidation inputs."""
    args = (np.asarray([np.inf, np.inf], np.float32), np.asarray([1.0, 2.0, 3.0], np.float32),
            np.asarray([0, 1, 0]), np.asarray([0.0, 5.0], np.float32))
    want, got = _ref_scan(*args), _port_scan(*args)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tolist() == [False, True, False]


def test_cold_cache_and_empty_stream():
    state = cache.cold_cache(5, device="cpu")
    assert isinstance(state, cache.CacheState)
    np.testing.assert_array_equal(state.expiry.numpy(), np.asarray(ref_cache.cold_cache(5).expiry))
    e, h = cache.ttl_cache_scan(state.expiry, torch.zeros(0), torch.zeros(0, dtype=torch.int64),
                                torch.ones(5))
    assert h.shape == (0,) and torch.equal(e, state.expiry)


# -------------------------------------------------------- simulate_ttl_cache


def test_simulate_ttl_cache_on_the_reference_draws():
    model = ref_cache.CacheModel(**MODEL_KW)
    ttl = model.ttl(LAM)
    key, n = jax.random.key(0), 4000
    want_hit, want_req = ref_cache.simulate_ttl_cache(key, LAM, ttl, n)
    from repro.storage.simulator import generate_workload

    t, fid = generate_workload(key, jnp.asarray(LAM, jnp.float32), n)
    got_hit, got_req = cache.simulate_ttl_cache(
        None, LAM, ttl, n, device="cpu",
        draws=(torch.as_tensor(np.array(t)), torch.as_tensor(np.array(fid), dtype=torch.int64)))
    np.testing.assert_array_equal(got_req, np.asarray(want_req))
    np.testing.assert_array_equal(got_hit, np.asarray(want_hit))


def test_empirical_hit_rates_match_che():
    """tests/test_cache.py's claim on the port's own generator."""
    model = cache.CacheModel(**MODEL_KW)
    ttl = model.ttl(LAM)
    hits, reqs = cache.simulate_ttl_cache(torch.Generator().manual_seed(0), LAM, ttl, 20000,
                                          device="cpu")
    emp = hits / np.maximum(reqs, 1)
    np.testing.assert_allclose(emp, cache.che_hit_rates(LAM, ttl), atol=0.03)
    with pytest.raises(ValueError, match="Generator"):
        cache.simulate_ttl_cache(None, LAM, ttl, 10, device="cpu")
