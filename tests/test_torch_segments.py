"""The port's segmented simulator (failures, degraded reads, repair rows, the
cache tier, geo segments and candidate rollouts) against the reference, on
the CPU, on the reference's own draws.

* ``dispatch_masks`` on the inputs of ``tests/test_scenarios.py``'s
  degraded-read tests: the service sets and degraded flags equal the
  reference's wherever the Madow set itself agrees (flips counted: the
  float32 cumsum rounds differently in the last bit, ``ROADMAP.md`` §C).
* ``simulate_segment`` / ``simulate_segments`` / the geo segments and the
  candidate runners at 400-800 requests: latencies equal up to the first
  flipped Madow set, cache hits bitwise over the whole stream, and — with
  no flip — node counts exactly, the power sums s1-s3 within rtol 1e-5
  (float32 sums over N in another order), busy time within rtol 1e-6 and
  the carry bitwise.
* The port's own contracts: a host loop of ``simulate_segment`` is bitwise
  ``simulate_segments``; TTLs all zero are bitwise the cache-free run; with
  one draw each candidate of ``run_segment_batch`` is bitwise
  ``run_segment_raw`` for that plan alone.

The reference runs on its ``ref`` FCFS backend (the CPU default).
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
import repro_torch.core as P
import repro_torch.storage as PS
from repro_torch.core.scheduling import madow_sample
from repro_torch.storage.simulator import SimDraws
from test_torch_slice import _ref_madow_on_u
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
MB = float(2**20)
LAM2 = np.asarray([0.04, 0.03], np.float32)  # tests/test_scenarios.py
K2 = np.asarray([4.0, 6.0], np.float32)
LAM4 = np.asarray([0.09, 0.07, 0.04, 0.03], np.float32)  # tests/test_cache.py
K4 = np.asarray([4.0, 4.0, 6.0, 6.0], np.float32)
FILE_MB4 = np.asarray([50.0, 50.0, 75.0, 75.0])
GEO_LAM = np.asarray([0.036, 0.028, 0.016, 0.012], np.float32)  # fleet_scale.py
MIX = np.asarray([0.4, 0.25, 0.25, 0.1])


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_seg_draws(key, lam, n, m, geo):
    k_wl, k_sel, k_srv = jax.random.split(key, 3)
    if geo:
        rel, fid, sid = ref_sim.generate_geo_workload(k_wl, lam, n)
    else:
        rel, fid = ref_sim.generate_workload(k_wl, lam, n)
        sid = jnp.zeros_like(fid)
    e = jax.random.exponential(k_srv, (n, m))
    k_u, k_prio = jax.random.split(k_sel)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(jax.random.split(k_u, n))
    prio = jax.random.uniform(k_prio, (n, m))
    return rel, fid, u, e, sid, prio


def seg_draws(key, lam, n, m=M, geo=False):
    """The reference ``_run_segment``'s draws (or ``_run_geo_segment``'s,
    with ``geo``) for ``key``, with its own key splits: ``split(key, 3)``
    into workload, selection and service keys; the Madow uniforms from
    ``split(split(k_sel)[0], n)`` and the spare priorities from
    ``split(k_sel)[1]`` (``dispatch_masks``). Arrivals are relative. Drawn
    under ``jax.jit``, as every reference segment path runs: XLA sums the
    rates in another order eagerly, which moves the arrivals in the last
    bit."""
    rel, fid, u, e, sid, prio = _jax_seg_draws(key, jnp.asarray(lam), n, m, geo)
    return SimDraws(_t(rel), _t(fid, torch.int64), _t(u), _t(e), _t(sid, torch.int64),
                    _t(prio))


def stack_draws(draws):
    """Per-segment (or per-key) draws stacked on a new leading axis."""
    return SimDraws(*(torch.stack(xs) for xs in zip(*draws)))


def flips_of(draws, pi, ref_pi=None):
    """(…, N) bool: requests whose Madow set differs between the packages."""
    pi = _t(pi)
    ref_pi = pi if ref_pi is None else _t(ref_pi)
    rows = ref_pi[draws.file_id]
    flat_u, flat_rows = draws.u.reshape(-1), rows.reshape(-1, rows.shape[-1])
    ref = np.asarray(jax.vmap(_ref_madow_on_u)(jnp.asarray(flat_u.numpy()),
                                               jnp.asarray(flat_rows.numpy())))
    port = madow_sample(draws.u, pi[draws.file_id]).reshape(ref.shape).numpy()
    return torch.as_tensor((ref != port).any(-1).reshape(tuple(draws.u.shape)))


def assert_stream_matches(port, ref, flips):
    """Latency up to the first flip, hits over the whole stream, and —
    with no flip — degraded flags, counts, power sums and busy time."""
    assert flips.float().mean() <= 1e-3, f"{int(flips.sum())} Madow sets flipped"
    lat, want = port.latency.numpy(), np.asarray(ref.latency)
    fl = flips.numpy().reshape(-1, lat.shape[-1])
    for row, (got_row, want_row) in enumerate(zip(lat.reshape(fl.shape), want.reshape(fl.shape))):
        stop = int(np.argmax(fl[row])) if fl[row].any() else fl.shape[1]
        np.testing.assert_array_equal(got_row[:stop], want_row[:stop])
    np.testing.assert_array_equal(port.file_id.numpy(), np.asarray(ref.file_id))
    np.testing.assert_array_equal(port.arrival.numpy(), np.asarray(ref.arrival))
    if getattr(ref, "hit", None) is not None:
        np.testing.assert_array_equal(port.hit.numpy(), np.asarray(ref.hit))
    if flips.any():
        return
    np.testing.assert_array_equal(lat, want)
    np.testing.assert_array_equal(port.degraded.numpy(), np.asarray(ref.degraded))
    np.testing.assert_array_equal(port.obs.count.numpy(), np.asarray(ref.obs.count))
    for name in ("s1", "s2", "s3"):
        np.testing.assert_allclose(getattr(port.obs, name).numpy(),
                                   np.asarray(getattr(ref.obs, name)), rtol=1e-5)
    np.testing.assert_allclose(port.node_busy.numpy(), np.asarray(ref.node_busy), rtol=1e-6)


def assert_carry_equal(port, ref):
    np.testing.assert_array_equal(port.dep.numpy(), np.asarray(ref.dep))
    assert float(port.t0) == float(ref.t0)
    if ref.cache is None:
        assert port.cache is None
    else:
        np.testing.assert_array_equal(port.cache.numpy(), np.asarray(ref.cache))


@pytest.fixture(scope="module")
def clusters():
    return RS.tahoe_testbed(), PS.tahoe_testbed(device="cpu")


@pytest.fixture(scope="module")
def pi2():
    return np.array(R.feasible_uniform(jnp.ones((2, M), bool), jnp.asarray(K2)))


@pytest.fixture(scope="module")
def pi4():
    """A non-uniform 4-file plan: projected random rows, k = 4, 4, 6, 6."""
    rng = np.random.default_rng(0)
    return np.array(R.project_capped_simplex(
        jnp.asarray(rng.random((4, M)), jnp.float32), jnp.asarray(K4)))


@pytest.fixture(scope="module")
def model():
    return RS.CacheModel(file_bytes=FILE_MB4 * MB, capacity_bytes=100.0 * MB,
                         hit_latency=0.5, hot_price_per_mb=0.02)


# ------------------------------------------------------------ dispatch masks


def _avail(down=(), up=None):
    if up is not None:
        a = np.zeros(M, bool)
        a[list(up)] = True
        return a
    a = np.ones(M, bool)
    a[list(down)] = False
    return a


# (workload key, dispatch key, n, avail) of tests/test_scenarios.py's
# degraded-read tests: k-of-n kept, thin availability, a partial site mix,
# all up
DISPATCH_CASES = {
    "degraded_reads_keep_k_of_n": (1, 2, 600, _avail(down=(0, 5))),
    "thin_availability_widens_to_avail": (11, 12, 300, _avail(up=(2, 7, 9))),
    "thin_availability_partial_site_mix": (13, 14, 400, _avail(down=range(7))),
    "all_up_matches_plain_madow_sum": (3, 4, 400, _avail()),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_masks_match_reference(case, pi2):
    k_wl, k_disp, n, avail = DISPATCH_CASES[case]
    _, fid = ref_sim.generate_workload(jax.random.key(k_wl), jnp.asarray(LAM2), n)
    want_masks, want_deg = ref_sim.dispatch_masks(jax.random.key(k_disp), jnp.asarray(pi2),
                                                  fid, avail)
    k_u, k_prio = jax.random.split(jax.random.key(k_disp))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(jax.random.split(k_u, n))
    prio = jax.random.uniform(k_prio, (n, M))
    fid_t = _t(fid, torch.int64)
    masks, deg = PS.dispatch_masks(_t(u), _t(prio), _t(pi2), fid_t, avail)
    flips = flips_of(SimDraws(None, fid_t, _t(u), None), pi2)
    assert flips.float().mean() <= 1e-3
    keep = ~flips.numpy()
    np.testing.assert_array_equal(masks.numpy()[keep], np.asarray(want_masks)[keep])
    np.testing.assert_array_equal(deg.numpy()[keep], np.asarray(want_deg)[keep])
    # the reference tests' own claims, on the port's output
    sizes = masks.sum(-1).numpy()
    k_req = K2.astype(int)[fid_t.numpy()]
    if case == "thin_availability_widens_to_avail":
        np.testing.assert_array_equal(masks.numpy(), np.broadcast_to(avail, masks.shape))
        assert deg.all()
    elif case == "thin_availability_partial_site_mix":
        np.testing.assert_array_equal(sizes, np.minimum(k_req, avail.sum()))
        assert not masks[:, :7].any()
    else:
        np.testing.assert_array_equal(sizes, k_req)
        assert not masks.numpy()[:, ~avail].any()
        assert bool(deg.any()) == (not avail.all())


# ----------------------------------------------------------------- segments


SEGMENT_CASES = {
    # (key, n, avail, rate_scale, overhead_scale, bandwidth_scale, cached)
    "plain": (7, 400, _avail(), 1.0, 1.0, 1.0, False),
    "failure_and_cache": (3, 600, _avail(down=(0, 5)), 1.0, 1.0, 1.0, True),
    "drift_per_file_and_node": (
        21, 500, _avail(down=(4,)), np.asarray([1.5, 0.5, 1.0, 2.0]),
        np.linspace(0.8, 1.4, M), np.linspace(1.2, 0.6, M), True),
}


def _segment_pair(clusters, pi, key, n, avail, rate_scale, ovh, bw, ttl, carry=None,
                  ref_carry=None):
    ref_cl, cl = clusters
    lam_s = jnp.asarray(LAM4) * (jnp.asarray(rate_scale) if np.ndim(rate_scale) else rate_scale)
    want, want_carry = ref_sim.simulate_segment(
        key, jnp.asarray(pi), jnp.asarray(LAM4), ref_cl, 12.5, n, avail=avail,
        rate_scale=rate_scale, overhead_scale=ovh, bandwidth_scale=bw, carry=ref_carry,
        cache_ttl=ttl, cache_hit_latency=0.5)
    draws = seg_draws(key, lam_s, n)
    got, got_carry = PS.simulate_segment(
        None, _t(pi), LAM4, cl, 12.5, n, avail=avail, rate_scale=rate_scale,
        overhead_scale=ovh, bandwidth_scale=bw, carry=carry, cache_ttl=ttl,
        cache_hit_latency=0.5, draws=draws)
    return want, want_carry, got, got_carry, draws


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_simulate_segment_matches_reference(case, clusters, pi4, model):
    seed, n, avail, rate_scale, ovh, bw, cached = SEGMENT_CASES[case]
    ttl = model.ttl(LAM4.astype(np.float64)) if cached else None
    want, want_carry, got, got_carry, draws = _segment_pair(
        clusters, pi4, jax.random.key(seed), n, avail, rate_scale, ovh, bw, ttl)
    assert_stream_matches(got, want, flips_of(draws, pi4))
    assert_carry_equal(got_carry, want_carry)
    # a second segment from the carry: queue state and cache warmth go on
    want2, want_carry2, got2, got_carry2, draws2 = _segment_pair(
        clusters, pi4, jax.random.key(seed + 100), n, avail, rate_scale, ovh, bw, ttl,
        carry=got_carry, ref_carry=want_carry)
    assert_stream_matches(got2, want2, flips_of(draws2, pi4))
    assert_carry_equal(got_carry2, want_carry2)
    if cached:
        hit = got.hit.numpy()
        lat = got.latency.numpy()
        assert hit.any() and (~hit).any()
        np.testing.assert_array_equal(lat[hit], np.float32(0.5))
        assert not got.degraded.numpy()[hit].any()


def _schedule(pi4, model):
    """tests/test_scenarios.py's failure schedule on the 4-file plan with
    repair rows (on while node 0 is down) and the cache tier (TTL 0 on the
    repair rows, an all-zero outage row in segment 2)."""
    s = 4
    avail_seq = np.ones((s, M), bool)
    avail_seq[1:3, 0] = False
    placement = pi4 > 1e-6
    flow = RS.build_repair_flow(placement, K4, avail_seq[1], 0.05)
    pi_aug, lam_aug = RS.augment_plan(pi4, LAM4, flow)
    rate_scale = np.ones((s, 8), np.float32)
    rate_scale[:, 4:] = 0.0
    rate_scale[1:3, 4:] = 1.0
    ttl = np.concatenate([model.ttl(LAM4.astype(np.float64)), np.zeros(4)])
    ttl_seq = np.tile(ttl, (s, 1))
    ttl_seq[2] = 0.0
    return dict(pi=np.asarray(pi_aug, np.float32), lam=np.asarray(lam_aug, np.float32),
                avail_seq=avail_seq, rate_scale_seq=rate_scale, cache_ttl_seq=ttl_seq)


def _segments_pair(clusters, sched, key, n, **extra):
    ref_cl, cl = clusters
    kw = dict(avail_seq=sched["avail_seq"], rate_scale_seq=sched["rate_scale_seq"],
              cache_ttl_seq=sched["cache_ttl_seq"], cache_hit_latency=0.5, **extra)
    want = ref_sim.simulate_segments(key, jnp.asarray(sched["pi"]), jnp.asarray(sched["lam"]),
                                     ref_cl, 12.5, n, **kw)
    keys = jax.random.split(key, sched["avail_seq"].shape[0])
    scale = jnp.asarray(sched["rate_scale_seq"], jnp.float32)
    draws = stack_draws([seg_draws(k, jnp.asarray(sched["lam"]) * scale[i], n)
                         for i, k in enumerate(keys)])
    got = PS.simulate_segments(None, sched["pi"], sched["lam"], cl, 12.5, n, draws=draws, **kw)
    return want, got, draws


def test_simulate_segments_with_repair_rows_outage_and_cache(clusters, pi4, model):
    sched = _schedule(pi4, model)
    want, got, draws = _segments_pair(clusters, sched, jax.random.key(9), 500)
    assert_stream_matches(got, want, flips_of(draws, sched["pi"]))
    hit, fid = got.hit.numpy(), got.file_id.numpy()
    busy, count = got.node_busy.numpy(), got.obs.count.numpy()
    assert hit[[0, 1, 3]].any(axis=1).all() and hit[2].sum() == 0  # the outage row
    assert hit[fid >= 4].sum() == 0  # repair rows never hit
    assert (fid[[1, 2]] >= 4).any() and (fid[[0, 3]] < 4).all()  # repair only while down
    assert busy[1, 0] == 0.0 and busy[2, 0] == 0.0 and count[1:3, 0].sum() == 0
    assert (np.diff(got.t_end.numpy()) > 0).all()


def test_simulate_segments_failure_schedule_matches_reference(clusters, pi2):
    """tests/test_scenarios.py::test_failure_segment_removes_node_from_service's
    inputs (4 segments x 1500 requests, node 0 down in 1-2), no cache."""
    ref_cl, cl = clusters
    avail = np.ones((4, M), bool)
    avail[1:3, 0] = False
    key = jax.random.key(0)
    want = ref_sim.simulate_segments(key, jnp.asarray(pi2), jnp.asarray(LAM2), ref_cl, 12.5,
                                     1500, avail_seq=avail)
    draws = stack_draws([seg_draws(k, jnp.asarray(LAM2) * jnp.float32(1.0), 1500)
                         for k in jax.random.split(key, 4)])
    got = PS.simulate_segments(None, pi2, LAM2, cl, 12.5, 1500, avail_seq=avail, draws=draws)
    assert got.hit is None
    assert_stream_matches(got, want, flips_of(draws, pi2))
    deg = got.degraded.numpy().mean(-1)
    assert deg[0] == 0.0 and deg[3] == 0.0 and deg[1] > 0.0 and deg[2] > 0.0


def test_host_loop_is_bitwise_simulate_segments(clusters, pi4, model):
    sched = _schedule(pi4, model)
    cl = clusters[1]
    gen = torch.Generator().manual_seed(5)
    s, n = sched["avail_seq"].shape[0], 400
    lam = _t(sched["lam"])
    draws = stack_draws([PS.simulator._draw(
        gen, (lam * _t(sched["rate_scale_seq"][i]))[None], (n,), M, prio=True)
        for i in range(s)])
    whole = PS.simulate_segments(None, sched["pi"], sched["lam"], cl, 12.5, n, draws=draws,
                                 avail_seq=sched["avail_seq"],
                                 rate_scale_seq=sched["rate_scale_seq"],
                                 cache_ttl_seq=sched["cache_ttl_seq"], cache_hit_latency=0.5)
    carry, parts = None, []
    for i in range(s):
        res, carry = PS.simulate_segment(
            None, sched["pi"], sched["lam"], cl, 12.5, n, avail=sched["avail_seq"][i],
            rate_scale=sched["rate_scale_seq"][i], carry=carry,
            cache_ttl=sched["cache_ttl_seq"][i], cache_hit_latency=0.5, draws=draws.at(i))
        parts.append(res)
    loop = PS.simulator._stack(parts)
    for a, b in zip(torch.utils._pytree.tree_leaves(loop), torch.utils._pytree.tree_leaves(whole)):
        assert torch.equal(a, b)


def test_zero_ttls_are_bitwise_the_cache_free_run(clusters, pi4, model):
    sched = _schedule(pi4, model)
    cl = clusters[1]
    gen = torch.Generator().manual_seed(11)
    draws = stack_draws([PS.simulator._draw(gen, _t(sched["lam"])[None], (300,), M, prio=True)
                         for _ in range(4)])
    kw = dict(avail_seq=sched["avail_seq"], rate_scale_seq=sched["rate_scale_seq"], draws=draws)
    free = PS.simulate_segments(None, sched["pi"], sched["lam"], cl, 12.5, 300, **kw)
    zero = PS.simulate_segments(None, sched["pi"], sched["lam"], cl, 12.5, 300,
                                cache_ttl_seq=np.zeros((4, 8)), cache_hit_latency=0.5, **kw)
    assert zero.hit.sum() == 0 and free.hit is None
    for name in ("latency", "arrival", "node_busy", "degraded", "t_end"):
        assert torch.equal(getattr(zero, name), getattr(free, name))
    for a, b in zip(zero.obs, free.obs):
        assert torch.equal(a, b)
    one, _ = PS.simulate_segment(None, sched["pi"], sched["lam"], cl, 12.5, 300,
                                 draws=draws.at(0))
    one_zero, _ = PS.simulate_segment(None, sched["pi"], sched["lam"], cl, 12.5, 300,
                                      cache_ttl=np.zeros(8), draws=draws.at(0))
    assert torch.equal(one.latency, one_zero.latency)


def test_segment_schedules_validate_like_the_reference(clusters, pi2):
    cl = clusters[1]
    with pytest.raises(ValueError, match="inconsistent segment counts"):
        PS.simulate_segments(torch.Generator(), pi2, LAM2, cl, 12.5, 10,
                             avail_seq=np.ones((3, M), bool), rate_scale_seq=np.ones(4))
    with pytest.raises(ValueError, match="cannot infer the segment count"):
        PS.simulate_segments(torch.Generator(), pi2, LAM2, cl, 12.5, 10)
    with pytest.raises(ValueError, match="prio"):
        PS.simulate_segment(None, pi2, LAM2, cl, 12.5, 10, draws=SimDraws(
            torch.arange(10.0), torch.zeros(10, dtype=torch.int64), torch.rand(10),
            torch.ones(10, M)))


def test_init_carry_and_generator_path(clusters, pi4, model):
    cl = clusters[1]
    carry = PS.init_carry(M, cache_files=4, device="cpu")
    assert carry.dep.shape == (M,) and float(carry.t0) == 0.0
    assert torch.isneginf(carry.cache).all()
    res, nxt = PS.simulate_segment(torch.Generator().manual_seed(0), pi4, LAM4, cl, 12.5, 400,
                                   cache_ttl=model.ttl(LAM4.astype(np.float64)),
                                   cache_hit_latency=0.5, avail=_avail(down=(0,)))
    assert torch.isfinite(res.latency).all() and res.hit.any()
    assert float(nxt.t0) == float(res.arrival[-1]) and int(res.obs.count[0]) == 0
    np.testing.assert_array_equal(res.node_busy.numpy()[0], 0.0)


# ------------------------------------------------------------- geo segments


@pytest.fixture(scope="module")
def fabrics(clusters):
    return RS.geo_testbed(), PS.geo_testbed(clusters[1])


def _geo_pi():
    rng = np.random.default_rng(3)
    return np.array(R.project_capped_simplex(
        jnp.asarray(rng.random((4, M)), jnp.float32), jnp.asarray(K4)))


def _sun_schedule(s=4):
    """Follow-the-sun: the client mix rotates one site a segment."""
    return np.stack([np.roll(MIX, i)[:, None] * GEO_LAM[None, :] for i in range(s)]
                    ).astype(np.float32)


def assert_geo_obs_sum_to_masks(res, draws, pi, avail_seq):
    """Per-(site, node) counts sum over sites to the served masks."""
    masks = torch.stack([PS.dispatch_masks(draws.u[i], draws.prio[i], _t(pi), draws.file_id[i],
                                           avail_seq[i])[0] for i in range(len(avail_seq))])
    np.testing.assert_array_equal(res.obs.count.sum(-2).numpy(), masks.sum(-2).numpy())


def test_geo_segments_match_reference(fabrics):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    lam_seq = _sun_schedule()
    avail = np.ones((4, M), bool)
    avail[2, 3] = False
    key, n = jax.random.key(4), 600
    want = ref_sim.simulate_geo_segments(key, jnp.asarray(pi), jnp.asarray(lam_seq), ref_fab,
                                         12.5, n, avail_seq=avail)
    draws = stack_draws([seg_draws(k, lam_seq[i], n, geo=True)
                         for i, k in enumerate(jax.random.split(key, 4))])
    got = PS.simulate_geo_segments(None, pi, lam_seq, fab, 12.5, n, avail_seq=avail,
                                   draws=draws)
    assert got.obs.count.shape == (4, 4, M)
    np.testing.assert_array_equal(got.site_id.numpy(), np.asarray(want.site_id))
    assert_stream_matches(got, want, flips_of(draws, pi))
    assert_geo_obs_sum_to_masks(got, draws, pi, avail)
    with pytest.raises(ValueError, match=r"\(S, C, r\)"):
        PS.simulate_geo_segments(None, pi, lam_seq[0], fab, 12.5, n, draws=draws)


def test_geo_segment_with_carry_and_drift_matches_reference(fabrics):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    lam_cs = (MIX[:, None] * GEO_LAM[None, :]).astype(np.float32)
    ovh = np.ones((4, M), np.float32)
    ovh[0, 4:8] = 1.5  # NJ's egress to TX degrades
    bw = np.ones((4, M), np.float32)
    bw[0, 4:8] = 0.7
    want, want_carry, got, got_carry = None, None, None, None
    for seed in (5, 6):
        key = jax.random.key(seed)
        want, want_carry = ref_sim.simulate_geo_segment(
            key, jnp.asarray(pi), jnp.asarray(lam_cs), ref_fab, 12.5, 500, rate_scale=1.3,
            overhead_scale=ovh, bandwidth_scale=bw, carry=want_carry)
        draws = seg_draws(key, jnp.asarray(lam_cs) * 1.3, 500, geo=True)
        got, got_carry = PS.simulate_geo_segment(
            None, pi, lam_cs, fab, 12.5, 500, rate_scale=1.3, overhead_scale=ovh,
            bandwidth_scale=bw, carry=got_carry, draws=draws)
        assert_stream_matches(got, want, flips_of(draws, pi))
        assert_carry_equal(got_carry, want_carry)


# ------------------------------------------------------- candidate rollouts


def _candidates(pi, b=3):
    """(1 - a) pi + a uniform-over-support(pi) for a in [0, 1]."""
    uni = np.asarray(R.feasible_uniform(jnp.asarray(pi > 1e-6), jnp.asarray(pi.sum(-1))))
    alphas = np.linspace(0.0, 1.0, b)
    return np.stack([(1 - a) * pi + a * uni for a in alphas]).astype(np.float32)




def test_run_segment_batch_matches_reference(clusters, pi4, model):
    ref_cl, cl = clusters
    stack = _candidates(pi4)
    ttl = model.ttl(LAM4.astype(np.float64)).astype(np.float32)
    avail = _avail(down=(2,))
    # a carry with queue state and warmth: one segment in
    _, want_carry = ref_sim.simulate_segment(jax.random.key(1), jnp.asarray(pi4),
                                             jnp.asarray(LAM4), ref_cl, 12.5, 400,
                                             cache_ttl=ttl)
    _, carry = PS.simulate_segment(None, pi4, LAM4, cl, 12.5, 400, cache_ttl=ttl,
                                   draws=seg_draws(jax.random.key(1), jnp.asarray(LAM4) * 1.0,
                                                   400))
    assert_carry_equal(carry, want_carry)
    d, rate = ref_cl.service_params(12.5)
    keys = jax.random.split(jax.random.key(2), 2)
    want = ref_sim.run_segment_batch(want_carry, keys, jnp.asarray(stack), jnp.asarray(LAM4), d,
                                     rate, jnp.asarray(avail), 400, jnp.asarray(ttl),
                                     jnp.float32(0.5))
    draws = stack_draws([seg_draws(k, LAM4, 400) for k in keys])
    pd, prate = cl.service_params(12.5)
    got = PS.run_segment_batch(carry, None, _t(stack), _t(LAM4), pd, prate, _t(avail, torch.bool),
                               400, _t(ttl), 0.5, draws=draws)
    assert got.latency.shape == (3, 2, 400) and got.obs.count.shape == (3, 2, M)
    assert got.t_end.shape == (3, 2)
    flips = torch.stack([flips_of(draws, p, p) for p in stack])
    assert_stream_matches(got, want, flips)


def test_candidate_rollouts_with_one_draw_are_run_segment_raw(clusters, pi4, model):
    cl = clusters[1]
    stack = _t(_candidates(pi4, b=4))
    gen = torch.Generator().manual_seed(3)
    carry = PS.init_carry(M, cache_files=4, device="cpu")._replace(
        dep=torch.rand(M, generator=gen) * 50, t0=torch.tensor(20.0))
    draws = PS.simulator._draw(gen, _t(LAM4)[None], (1, 500), M, prio=True)
    d, rate = cl.service_params(12.5)
    avail = torch.ones(M, dtype=torch.bool)
    avail[7] = False
    ttl = _t(model.ttl(LAM4.astype(np.float64)))
    batch = PS.run_segment_batch(carry, None, stack, _t(LAM4), d, rate, avail, 500, ttl, 0.5,
                                 draws=draws)
    for b in range(stack.shape[0]):
        _, one = PS.run_segment_raw(carry, None, stack[b], _t(LAM4), d, rate, avail, 500, ttl,
                                    0.5, draws=draws.at(0))
        for name in ("latency", "degraded", "node_busy", "hit", "arrival"):
            assert torch.equal(getattr(batch, name)[b, 0], getattr(one, name)), name
        for a, c in zip(batch.obs, one.obs):
            assert torch.equal(a[b, 0], c)


def test_run_geo_segment_batch_matches_reference(fabrics):
    ref_fab, fab = fabrics
    pi = _geo_pi()
    stack = _candidates(pi)
    lam_cs = (MIX[:, None] * GEO_LAM[None, :]).astype(np.float32)
    want_carry = ref_sim.init_carry(M)._replace(dep=jnp.linspace(0.0, 40.0, M),
                                                t0=jnp.float32(10.0))
    carry = PS.init_carry(M, device="cpu")._replace(dep=_t(np.asarray(want_carry.dep)),
                                                     t0=torch.tensor(10.0))
    d, rate = ref_fab.service_params(12.5)
    keys = jax.random.split(jax.random.key(8), 2)
    avail = _avail(down=(9,))
    want = ref_sim.run_geo_segment_batch(want_carry, keys, jnp.asarray(stack),
                                         jnp.asarray(lam_cs), d, rate, jnp.asarray(avail), 400)
    draws = stack_draws([seg_draws(k, lam_cs, 400, geo=True) for k in keys])
    pd, prate = fab.service_params(12.5)
    got = PS.run_geo_segment_batch(carry, None, _t(stack), _t(lam_cs), pd, prate,
                                   _t(avail, torch.bool), 400, draws=draws)
    assert got.obs.count.shape == (3, 2, 4, M)
    np.testing.assert_array_equal(got.site_id.numpy(), np.asarray(want.site_id))
    flips = torch.stack([flips_of(draws, p, p) for p in stack])
    assert_stream_matches(got, want, flips)
