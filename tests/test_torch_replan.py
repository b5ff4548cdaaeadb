"""The port's rollout arbitration and ``AdaptiveReplanner`` against the
reference, on the CPU, at the sizes of ``tests/test_replan_batch.py``, on
the reference's own draws (``tests/test_torch_segments.py::seg_draws``).

* ``batched_rollout_scores`` against the reference's (padding, the draw
  axis as a mean, repair rows masked, the cache and geo paths, a composed
  objective) and against the port's own host scoring of
  ``run_segment_raw``'s streams;
* ``AdaptiveReplanner.replan`` plain, warm, repair-augmented and
  cache-aware: the chosen candidate matches the reference's, pi within the
  flat-valley tolerance of ``ROADMAP.md`` §C (the solver stops on a
  last-bit difference), and the batched arbitration equals the sequential
  loop's bitwise.

The reference runs on its ``ref`` FCFS backend; no test launches a kernel.
"""
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
from repro_torch.serving.router import _pow2
from test_torch_segments import seg_draws, stack_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MB = 1024 * 1024
LAM = np.asarray([0.030, 0.020, 0.015, 0.012])  # tests/test_replan_batch.py
K4 = np.asarray([4.0, 4.0, 6.0, 6.0])
CHUNK_MB = 150.0 / 4
N_REQ = 200
PI_ATOL = 2e-3  # flat-valley stops (ROADMAP.md §C: Router.plan ends 1.4e-3 apart)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def clusters():
    return RS.tahoe_testbed(), PS.tahoe_testbed(device="cpu")


@pytest.fixture(scope="module")
def fabrics():
    return RS.geo_testbed(), PS.geo_testbed(PS.tahoe_testbed(device="cpu"))


# ------------------------------------------------------ batched rollouts


def _candidates(cluster, n_cand, scales=None):
    """tests/test_replan_batch.py's candidate fan, solved by the reference."""
    scales = np.linspace(0.8, 1.2, n_cand) if scales is None else scales
    probs = [R.JLCMProblem(lam=jnp.asarray(LAM * s, jnp.float32), k=jnp.asarray(K4, jnp.float32),
                           moments=cluster.moments(CHUNK_MB), cost=cluster.cost, theta=2.0)
             for s in scales]
    return np.asarray(R.solve_batch(R.stack_problems(probs), max_iters=60).pi)


def _params(cluster, lam=LAM):
    d, rates = cluster.service_params(CHUNK_MB)
    return np.asarray(lam, np.float32), np.asarray(d, np.float32), np.asarray(rates, np.float32)


ROLLOUT_CASES = {
    # (candidates, draws, seed, repair, cache)
    "padding": (3, 1, 5, False, False),
    "draw_axis_mean": (2, 3, 6, False, False),
    "repair_rows_masked": (3, 1, 11, True, False),
    "cache_ttl": (2, 2, 12, False, True),
}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_batched_rollout_scores_match_reference(case, clusters):
    n_cand, n_draws, seed, repair, cached = ROLLOUT_CASES[case]
    ref_cl, cl = clusters
    pi = _candidates(ref_cl, n_cand)
    lam = LAM
    if repair:
        avail = np.ones(12, bool)
        avail[0] = False
        flow = RS.build_repair_flow(pi[0] > 1e-6, K4, avail, 0.05)
        pi = np.stack([RS.augment_plan(p, LAM, flow)[0] for p in pi]).astype(np.float32)
        lam = np.concatenate([LAM, flow.lam])
    lam32, d, rates = _params(ref_cl, lam)
    cost = (2.0 * np.arange(1, n_cand + 1)).astype(np.float32)
    key = jax.random.key(seed)
    ttl = ttl_t = None
    hit_latency = 0.0
    carry_ref = RS.init_carry(12, cache_files=lam.size if cached else None)
    carry = PS.init_carry(12, cache_files=lam.size if cached else None, device="cpu")
    if cached:
        ttl = np.asarray([8.0, 8.0, 0.0, 4.0], np.float32)
        ttl_t, hit_latency = _t(ttl), 0.5
    avail = np.ones(12, bool)
    want, want_best = RSV.batched_rollout_scores(
        carry_ref, key, jnp.asarray(pi), jnp.asarray(lam32), jnp.asarray(d), jnp.asarray(rates),
        jnp.asarray(avail), jnp.asarray(cost), None, n_clients=4, n_requests=N_REQ,
        rollout_seeds=n_draws, ttl=None if ttl is None else jnp.asarray(ttl),
        hit_latency=hit_latency, devices="never")
    keys = key[None] if n_draws == 1 else jax.random.split(key, n_draws)
    draws = stack_draws([seg_draws(k, jnp.asarray(lam32), N_REQ) for k in keys])
    got, best = PSV.batched_rollout_scores(
        carry, None, _t(pi), _t(lam32), _t(d), _t(rates), _t(avail, torch.bool), _t(cost),
        None, n_clients=4, n_requests=N_REQ, rollout_seeds=n_draws, ttl=ttl_t,
        hit_latency=hit_latency, draws=draws)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (_pow2(n_cand),)
    assert np.isinf(got[n_cand:]).all()
    np.testing.assert_allclose(got[:n_cand], want[:n_cand], rtol=1e-5, atol=1e-5)
    assert int(best) == int(want_best)
    assert np.isfinite(got[:n_cand]).all()
    # the port's own contract: each candidate's score is its host score on
    # run_segment_raw's stream, client rows only, averaged over the draws
    for i in range(n_cand):
        per = []
        for j in range(n_draws):
            _, res = PS.run_segment_raw(carry, None, _t(pi[i]), _t(lam32), _t(d), _t(rates),
                                        _t(avail, torch.bool), N_REQ, ttl_t, hit_latency,
                                        draws=draws.at(j))
            lat, fid = res.latency.numpy(), res.file_id.numpy()
            per.append(P.empirical_objective(lat[fid < 4], fid[fid < 4], None))
        np.testing.assert_allclose(got[i], np.mean(per) + cost[i], rtol=1e-5)


def test_batched_rollout_scores_geo_and_composed_objective(fabrics):
    ref_fab, fab = fabrics
    rng = np.random.default_rng(7)
    pi = np.stack([np.asarray(R.project_capped_simplex(
        jnp.asarray(rng.random((4, 12)), jnp.float32), jnp.asarray(K4))) for _ in range(3)])
    lam_cs = (np.asarray(ref_fab.uniform_mix(4)).T * LAM).astype(np.float32)
    d, rates = (np.asarray(x) for x in ref_fab.service_params(12.5))
    spec_args = dict(class_id=[0, 0, 1, 1], weight=[3.0, 1.0], deadline=[15.0, np.inf],
                     tail_weight=[5.0, 0.0])
    key = jax.random.key(13)
    cost = np.zeros(3, np.float32)
    want, want_best = RSV.batched_rollout_scores(
        RS.init_carry(12), key, jnp.asarray(pi), jnp.asarray(lam_cs), jnp.asarray(d),
        jnp.asarray(rates), jnp.ones((12,), bool), jnp.asarray(cost),
        R.make_objective(**spec_args), n_clients=4, n_requests=N_REQ, devices="never", geo=True)
    draws = stack_draws([seg_draws(key, jnp.asarray(lam_cs), N_REQ, geo=True)])
    got, best = PSV.batched_rollout_scores(
        PS.init_carry(12, device="cpu"), None, _t(pi), _t(lam_cs), _t(d), _t(rates),
        torch.ones(12, dtype=torch.bool), _t(cost), P.make_objective(**spec_args, device="cpu"),
        n_clients=4, n_requests=N_REQ, geo=True, draws=draws)
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], rtol=1e-5, atol=1e-5)
    assert got.shape == (4,) and np.isinf(got.numpy()[3])
    assert int(best) == int(want_best)


def test_batched_rollout_scores_generator_and_errors(clusters):
    ref_cl, cl = clusters
    pi = _t(_candidates(ref_cl, 2))
    lam32, d, rates = (_t(x) for x in _params(ref_cl))
    avail = torch.ones(12, dtype=torch.bool)
    carry = PS.init_carry(12, device="cpu")
    gen = torch.Generator().manual_seed(0)
    a, best = PSV.batched_rollout_scores(carry, gen, pi, lam32, d, rates, avail, torch.zeros(2),
                                         n_clients=4, n_requests=N_REQ, rollout_seeds=2)
    assert a.shape == (2,) and torch.isfinite(a).all() and 0 <= int(best) < 2
    draws = PS.segment_draws(torch.Generator().manual_seed(0), lam32[None], N_REQ, 12, 2)
    b, _ = PSV.batched_rollout_scores(carry, None, pi, lam32, d, rates, avail, torch.zeros(2),
                                      n_clients=4, n_requests=N_REQ, rollout_seeds=2, draws=draws)
    assert torch.equal(a, b)  # the generator draws what segment_draws draws
    with pytest.raises(ValueError, match="rollout_seeds"):
        PSV.batched_rollout_scores(carry, None, pi, lam32, d, rates, avail, torch.zeros(2),
                                   n_clients=4, n_requests=N_REQ, draws=draws)
    with pytest.raises(ValueError, match="devices"):
        PSV.batched_rollout_scores(carry, gen, pi, lam32, d, rates, avail, torch.zeros(2),
                                   n_clients=4, devices="shard")
    assert [_pow2(n) for n in (1, 2, 3, 4, 5, 9)] == [1, 2, 4, 4, 8, 16]


# -------------------------------------------------------- AdaptiveReplanner


def _replanners(clusters, **kw):
    """The reference's replanner and the port's batched and sequential ones,
    at tests/test_replan_batch.py's settings."""
    ref_cl, cl = clusters
    common = dict(k=K4.copy(), theta=2.0, max_iters=80, rollout_requests=N_REQ, **kw)
    ref = RSV.AdaptiveReplanner(cost=np.asarray(ref_cl.cost),
                                estimator=RSV.EwmaMomentEstimator(prior=ref_cl.moments(CHUNK_MB)),
                                **common)
    port = [PSV.AdaptiveReplanner(cost=cl.cost.numpy(), rollout_batched=batched,
                                  estimator=PSV.EwmaMomentEstimator(prior=cl.moments(CHUNK_MB)),
                                  **common)
            for batched in (True, False)]
    return ref, port


def _chosen(rp):
    return int(np.argmin(np.asarray(rp.last_scores)))


def _assert_replans_agree(ref, port, got, want, got_seq):
    bat, seq = port
    np.testing.assert_array_equal(got, got_seq)  # batched == sequential, bitwise
    np.testing.assert_allclose(np.asarray(bat.last_scores), seq.last_scores, rtol=1e-5, atol=1e-5)
    assert _chosen(bat) == _chosen(ref)
    np.testing.assert_allclose(got, want, atol=PI_ATOL)
    np.testing.assert_allclose(np.asarray(bat.last_scores), np.asarray(ref.last_scores),
                               rtol=2e-2)
    assert got.shape == want.shape and isinstance(got, np.ndarray)
    assert len(bat.rollout_walls) == len(seq.rollout_walls) == len(ref.rollout_walls)
    assert len(bat.solve_iters) == len(bat.solve_walls) == bat.replans == 1


MASK0 = np.concatenate([[False], np.ones(11, bool)])

REPLAN_CASES = {"plain": 9, "warm_start_candidates": 10, "repair_augmented": 11}


@pytest.mark.parametrize("case", sorted(REPLAN_CASES))
def test_adaptive_replan_matches_reference(case, clusters):
    seed = REPLAN_CASES[case]
    ref, port = _replanners(clusters)
    avail = np.ones(12, bool)
    kw, lam = {}, LAM
    if case == "warm_start_candidates":
        kw = dict(pi0=_candidates(clusters[0], 1)[0], candidate_masks=[avail, MASK0])
    if case == "repair_augmented":
        avail = MASK0.copy()
        flow = RS.build_repair_flow(_candidates(clusters[0], 1)[0] > 1e-6, K4, avail, 0.05)
        kw, lam = dict(repair=flow), np.concatenate([LAM, flow.lam])
    key = jax.random.key(seed)
    want = ref.replan(LAM, avail, carry=RS.init_carry(12), key=key, **kw)
    draws = stack_draws([seg_draws(key, jnp.asarray(lam, jnp.float32), N_REQ)])
    got, got_seq = (rp.replan(LAM, avail, carry=PS.init_carry(12, device="cpu"), draws=draws,
                              **kw) for rp in port)
    _assert_replans_agree(ref, port, got, want, got_seq)
    if case == "warm_start_candidates":
        assert np.asarray(port[0].last_scores).shape == (4,)
    if case == "repair_augmented":
        assert port[0].repair_pi.shape == (4, 12)
        np.testing.assert_array_equal(port[0].repair_pi, port[1].repair_pi)
        np.testing.assert_allclose(port[0].repair_pi, ref.repair_pi, atol=PI_ATOL)
        assert (port[0].repair_pi[:, 0] <= 1e-6).all() and (got[:, 0] <= 1e-6).all()


def test_adaptive_replan_cache_aware_matches_reference(clusters):
    model_args = dict(file_bytes=np.asarray([50.0, 50.0, 75.0, 75.0]) * MB,
                      capacity_bytes=100.0 * MB, hit_latency=0.5, hot_price_per_mb=0.02)
    ref_model, model = RS.CacheModel(**model_args), PS.CacheModel(**model_args)
    ref, port = _replanners(clusters, cache=ref_model)
    for rp in port:
        rp.cache = model
    for rp in [ref] + port:
        rp.last_ttl = model.ttl(LAM)
        rp.last_raw = LAM.copy()
    miss = model.thin(LAM)
    raw = model.reconstruct_raw_rates(miss, model.ttl(LAM), prior=LAM)
    key = jax.random.key(12)
    avail = np.ones(12, bool)
    want = ref.replan(miss, avail, carry=RS.init_carry(12, cache_files=4), key=key)
    draws = stack_draws([seg_draws(key, jnp.asarray(raw, jnp.float32), N_REQ)])
    got, got_seq = (rp.replan(miss, avail, carry=PS.init_carry(12, device="cpu"), draws=draws)
                    for rp in port)
    _assert_replans_agree(ref, port, got, want, got_seq)
    for rp in port:
        np.testing.assert_array_equal(rp.last_raw, ref.last_raw)
        np.testing.assert_array_equal(rp.last_ttl, ref.last_ttl)
    # a hot-tier outage plans at the full raw load with head-room, no hits
    got_out = port[0].replan(miss, avail, cache_up=False)
    want_out = ref.replan(miss, avail, cache_up=False)
    assert (port[0].last_ttl == 0).all()
    np.testing.assert_array_equal(port[0].last_raw, ref.last_raw)
    np.testing.assert_allclose(got_out, want_out, atol=PI_ATOL)
    assert len(port[0].rollout_walls) == 1  # the analytic fallback adds none


def test_adaptive_replan_analytic_fallback_and_thetas(clusters):
    ref, port = _replanners(clusters, thetas=(0.5, 2.0, 8.0))
    avail = np.ones(12, bool)
    want = ref.replan(LAM, avail)
    got = port[0].replan(LAM, avail)
    assert port[0].rollout_walls == []
    assert np.asarray(port[0].last_scores).shape == (3,)
    assert _chosen(port[0]) == _chosen(ref)
    np.testing.assert_allclose(port[0].last_scores, np.asarray(ref.last_scores), rtol=1e-3)
    np.testing.assert_allclose(got, want, atol=PI_ATOL)
    assert port[0].repair_pi is None


def test_adaptive_replan_with_a_generator_and_draw_axis(clusters):
    _, port = _replanners(clusters, rollout_seeds=2)
    avail = np.ones(12, bool)
    carry = PS.init_carry(12, device="cpu")
    pis = [rp.replan(LAM, avail, carry=carry, generator=torch.Generator().manual_seed(4))
           for rp in port]
    assert np.isfinite(pis[0]).all() and np.allclose(pis[0].sum(-1), K4, atol=1e-3)
    assert port[0].last_scores.shape == (1,)
    np.testing.assert_array_equal(pis[0], pis[1])
