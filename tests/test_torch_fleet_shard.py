"""A fleet's seeds and a replan's rollout lanes split over several devices,
on the CPU with a list of CPU devices standing in for the cards.

* ``simulator._simulate_fleet_on``: 7 seeds over 3 devices (padded to 9),
  the materialized and streaming paths, cached and uncached, on given
  draws and on a generator: every field bitwise the one-device fleet's
  (``devices="never"``), one B1 call a device (a chunk), and the latencies
  the reference's unsharded fleet's on the same draws up to the first
  flipped Madow set, as ``tests/test_torch_fleet_stream.py`` holds them.
* ``router._batched_rollout_scores_on``: B = 3 candidates at K = 1 and 2
  draws, over 2 devices (the pad, 4, divides) and over 3 (no pad of up to
  4 doublings divides: the one-device program runs), plain, cached and
  geo: scores bitwise and ``best`` equal to the one-device program's.

No test launches a kernel.
"""
import jax
import numpy as np
import pytest
import torch

import repro.storage as RS
import repro.storage.simulator as ref_sim
import repro_torch.core as P
import repro_torch.serving.router as router
import repro_torch.storage as PS
import repro_torch.storage.simulator as sim
from test_torch_fleet_stream import (
    GEO_LAM,
    MB,
    MIX,
    _geo_pi,
    _rows_equal_until_flip,
    chunk_draws,
    fleet_draws,
)
from test_torch_segments import flips_of
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
CPUS3 = [torch.device("cpu")] * 3
LAM4 = np.asarray([0.09, 0.07, 0.04, 0.03])


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def fabrics():
    return RS.geo_testbed(), PS.geo_testbed(PS.tahoe_testbed(device="cpu"))


@pytest.fixture(scope="module")
def ttl():
    return RS.CacheModel(file_bytes=np.asarray([50.0, 50.0, 75.0, 75.0]) * MB,
                         capacity_bytes=100.0 * MB, hit_latency=0.5).ttl(LAM4)


@pytest.fixture
def b1_calls(monkeypatch):
    """Every B1 call of the simulator, as the rows it was given."""
    calls = []
    real = sim.fcfs_scan

    def counted(t, *args):
        calls.append(t.shape[0])
        return real(t, *args)

    monkeypatch.setattr(sim, "fcfs_scan", counted)
    return calls


def _assert_fleets_equal(got, want):
    for field in ("latency", "file_id", "site_id", "node_busy", "hit", "hit_count"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            assert g.shape == w.shape and torch.equal(g, w), field
    for part in ("stream", "windows"):
        g, w = getattr(got, part), getattr(want, part)
        assert (g is None) == (w is None), part
        if g is not None:
            for a, b in zip(g, w):
                assert torch.equal(a, b), part


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_materialized_fleet_sharded_is_bitwise_and_matches_reference(fabrics, ttl, cached,
                                                                    b1_calls):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    lam_cs = (MIX[:, None] * GEO_LAM[None, :]).astype(np.float32)
    key, n, s = jax.random.key(4), 300, 7
    draws = fleet_draws(jax.random.split(key, s), lam_cs, n)
    kw = dict(draws=draws, cache_ttl=ttl if cached else None, cache_hit_latency=0.5)
    one = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, n, s, devices="never", **kw)
    assert b1_calls == [7]
    got = sim._simulate_fleet_on(CPUS3, None, pi, lam_cs, fab, 12.5, n, s, **kw)
    assert b1_calls[1:] == [3, 3, 3]  # 7 seeds padded to 9, one launch a device
    _assert_fleets_equal(got, one)
    assert got.latency.shape == (s, n - n // 10)
    # the reference's unsharded fleet on the same draws
    want = ref_sim.simulate_fleet(key, jax.numpy.asarray(pi), jax.numpy.asarray(lam_cs),
                                  ref_fab, 12.5, n, s, devices="never",
                                  cache_ttl=ttl if cached else None, cache_hit_latency=0.5)
    flips = flips_of(draws, pi)[:, n // 10:]
    assert flips.float().mean() <= 1e-3
    _rows_equal_until_flip(got.latency, want.latency, flips)
    if cached:
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_streaming_fleet_sharded_is_bitwise_and_matches_reference(fabrics, ttl, cached,
                                                                 b1_calls):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    lam_cs = (MIX[:, None] * GEO_LAM[None, :]).astype(np.float32)
    key, s, block, n_chunks = jax.random.key(6), 7, 200, 3
    draws = chunk_draws(key, lam_cs, block, s, n_chunks)
    kw = dict(stream=True, n_chunks=n_chunks, cache_ttl=ttl if cached else None,
              cache_hit_latency=0.5, keep_latency=True, draws=draws)
    one = PS.simulate_fleet(None, pi, lam_cs, fab, 12.5, block, s, devices="never", **kw)
    assert b1_calls == [7] * n_chunks
    got = sim._simulate_fleet_on(CPUS3, None, pi, lam_cs, fab, 12.5, block, s, **kw)
    assert b1_calls[n_chunks:] == [3] * (3 * n_chunks)
    _assert_fleets_equal(got, one)
    assert got.stream.count.shape == (s,) and got.windows.count.shape == (s, n_chunks)
    warm = int(block * n_chunks * 0.1)
    d, rates = ref_fab.service_params(12.5)
    _, _, want_busy, want_hits, want_lat = ref_sim._fleet_stream_batched(
        jax.random.split(key, s), jax.numpy.asarray(pi), jax.numpy.asarray(lam_cs), d, rates,
        jax.numpy.asarray(ttl, jax.numpy.float32) if cached else jax.numpy.zeros((1,)),
        jax.numpy.float32(0.5), n_chunks, block, warm, RS.DEFAULT_SKETCH, cached=cached,
        materialize=True)
    flips = torch.cat([flips_of(draws.at(w), pi) for w in range(n_chunks)], dim=1)
    assert flips.float().mean() <= 1e-3
    _rows_equal_until_flip(got.latency, want_lat, flips)
    if cached:
        np.testing.assert_array_equal(got.hit_count.numpy(), np.asarray(want_hits))
    if not flips.any():
        np.testing.assert_allclose(got.node_busy.numpy(), np.asarray(want_busy), rtol=1e-6)


@pytest.mark.parametrize("stream", [False, True], ids=["materialized", "stream"])
def test_fleet_sharded_on_a_generator_draws_once(fabrics, stream):
    """Fresh draws: made once on the inputs' device, so two generators from
    one seed give the sharded and the one-device fleet the same seeds."""
    fab = fabrics[1]
    lam_cs = _t(MIX[:, None] * GEO_LAM[None, :])
    kw = dict(stream=stream, n_chunks=2 if stream else 1)
    one = PS.simulate_fleet(torch.Generator().manual_seed(9), _geo_pi(), lam_cs, fab, 12.5,
                            150, 5, devices="never", **kw)
    got = sim._simulate_fleet_on([torch.device("cpu")] * 2, torch.Generator().manual_seed(9),
                                 _geo_pi(), lam_cs, fab, 12.5, 150, 5, **kw)
    _assert_fleets_equal(got, one)


def test_fleet_auto_on_the_cpu_runs_on_one_device(fabrics, b1_calls):
    fab = fabrics[1]
    lam_cs = _t(MIX[:, None] * GEO_LAM[None, :])
    PS.simulate_fleet(torch.Generator().manual_seed(1), _geo_pi(), lam_cs, fab, 12.5, 100, 5,
                      devices="auto")
    assert b1_calls == [5]


# ------------------------------------------------------------------ lanes
LAM = np.asarray([0.030, 0.020, 0.015, 0.012])
K4 = np.asarray([4.0, 4.0, 6.0, 6.0])
N_REQ = 200


def _stack(b: int, seed: int, k=K4):
    rng = np.random.default_rng(seed)
    return torch.stack([P.project_capped_simplex(_t(rng.random((len(k), M))), _t(k))
                        for _ in range(b)])


@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("case", ["plain", "cached", "geo"])
def test_rollout_lanes_sharded_are_bitwise(fabrics, case, k, n_dev, b1_calls):
    b = 3
    pi = _stack(b, 10 * k + n_dev)
    cost = _t(2.0 * np.arange(1, b + 1))
    gen = lambda: torch.Generator().manual_seed(100 + k)
    kw = dict(n_clients=4, n_requests=N_REQ, rollout_seeds=k)
    if case == "geo":
        fab = fabrics[1]
        d, rates = fab.service_params(150.0 / 4)
        lam = _t(MIX[:, None] * LAM[None, :])
        carry = PS.init_carry(M, device="cpu")
        args = (pi, lam, d, rates, torch.ones(M, dtype=torch.bool), cost)
        kw["geo"] = True
    else:
        cl = PS.tahoe_testbed(device="cpu")
        d, rates = cl.service_params(150.0 / 4)
        carry = PS.init_carry(M, cache_files=4 if case == "cached" else None, device="cpu")
        avail = torch.ones(M, dtype=torch.bool)
        avail[0] = False
        args = (pi, _t(LAM), d, rates, avail, cost)
        if case == "cached":
            kw.update(ttl=_t([8.0, 8.0, 0.0, 4.0]), hit_latency=0.5)
    want, want_best = router.batched_rollout_scores(carry, gen(), *args, devices="never", **kw)
    assert b1_calls == [b * k]
    got, best = router._batched_rollout_scores_on([torch.device("cpu")] * n_dev, carry, gen(),
                                                  *args, **kw)
    pad = router._lane_pad(b, k, n_dev)
    if n_dev == 3:  # 4, 8, 16, 32, 64 candidates: no lane count divides 3
        assert pad is None and b1_calls[1:] == [b * k]
        assert got.shape == want.shape == (4,)
    else:
        assert pad == 4 and b1_calls[1:] == [4 * k // n_dev] * n_dev
        assert got.shape == (pad,)
    assert torch.equal(got[:b], want[:b]) and torch.isinf(got[b:]).all()
    assert int(best) == int(want_best)
    assert torch.isfinite(got[:b]).all()


def test_lane_pad_grows_up_to_four_doublings():
    assert router._lane_pad(3, 1, 2) == 4
    assert router._lane_pad(3, 1, 8) == 8
    assert router._lane_pad(5, 3, 16) == 16  # 8 * 3 = 24 does not divide, 16 * 3 = 48 does
    assert router._lane_pad(3, 1, 64) == 64
    assert router._lane_pad(3, 1, 128) is None  # beyond four doublings of 4
    assert router._lane_pad(3, 2, 3) is None
