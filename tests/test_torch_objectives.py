"""The port's objective layer (``core/objectives.py``), the rest of
``core/latency_bound.py`` and the solver's optional problem fields and
modes, against the reference, on the CPU.

* Closed forms at the same pi and z (the weighted and background folds,
  ``tail_probability_bounds``, the class sums, ``composed_latency`` with a
  spec, a cache and background load, ``empirical_objective``) agree within
  rtol 1e-5: both run in float32, summing in other orders.
* Solves hold the tolerances of ``tests/test_torch_slice.py``: identical
  ``n`` and ``placement``, pi within atol 1e-3, ``objective``,
  ``latency_tight``, ``class_latency`` and ``class_tail`` within rtol 1e-3,
  ``cost`` within rtol 1e-5.
* The exactness contract holds inside the port, bit for bit: an all-zero
  hit vector and unit cost weights each solve exactly as the plain
  problem. A uniform spec's values are the plain ones bit for bit; its
  solve holds the reference's own bound for it (1e-6), since its gradient
  sums in another order, in both packages.
* ``benchmarks/tenant_tradeoff.py --smoke`` (3 weights x 2 deadlines, one
  ``solve_batch``, 6000 requests a plan) against the reference's batch,
  each plan simulated on the reference's own draws; the benchmark's
  asserts hold on the port's numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.storage.simulator as ref_sim
import repro_torch.core as P
from repro.storage import tahoe_testbed as ref_testbed
from repro_torch.core.scheduling import madow_sample
from repro_torch.storage import simulate, tahoe_testbed
from test_torch_slice import _port_draws, _ref_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
RTOL = 1e-5
LAM = (0.0675, 0.0525, 0.03, 0.0225)  # benchmarks/tenant_tradeoff.py
K = (4.0, 4.0, 6.0, 6.0)
CLASS_ID = (0, 0, 1, 1)
CHUNK_MB = 12.5
TAIL_WEIGHT = 10.0


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(port, ref, rtol=RTOL, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, **kw)


@pytest.fixture(scope="module")
def testbeds():
    return ref_testbed(), tahoe_testbed(device="cpu")


def _plan(seed=0, r=6):
    """A feasible plan (projected by the reference), rates and the two
    packages' moments of the testbed at 12.5 MB chunks."""
    rng = np.random.default_rng(seed)
    k = rng.choice([2.0, 3.0, 4.0], r).astype(np.float32)
    pi = np.array(R.project_capped_simplex(
        jnp.asarray(rng.random((r, M)), jnp.float32), jnp.asarray(k)))
    lam = rng.uniform(0.005, 0.02, r).astype(np.float32)
    return pi, k, lam


def _pair(objective=None, theta=2.0, lam=LAM, k=K, **fields):
    """The tenant catalog as both packages' problems; ``objective`` is
    ``make_objective``'s arguments."""
    ref_cl, cl = ref_testbed(), tahoe_testbed(device="cpu")
    ref = R.JLCMProblem(lam=jnp.asarray(lam, jnp.float32), k=jnp.asarray(k, jnp.float32),
                        moments=ref_cl.moments(CHUNK_MB), cost=ref_cl.cost, theta=theta)
    port = P.JLCMProblem(lam=_t(lam), k=_t(k), moments=cl.moments(CHUNK_MB),
                         cost=cl.cost, theta=theta)
    if objective is not None:
        ref = ref._replace(objective=R.make_objective(*objective))
        port = port._replace(objective=P.make_objective(*objective, device="cpu"))
    return ref, port


def _assert_same_solution(port, ref):
    np.testing.assert_array_equal(port.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(port.placement.numpy(), np.asarray(ref.placement))
    np.testing.assert_allclose(port.pi.numpy(), np.asarray(ref.pi), atol=1e-3)
    for name in ("objective", "latency_tight", "class_latency", "class_tail"):
        got, want = getattr(port, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            _close(got, want, rtol=1e-3)
    _close(port.cost, ref.cost)


def _assert_bitwise(a, b):
    for name in ("pi", "z", "objective", "latency_tight", "cost", "objective_trace"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ------------------------------------------------------------ latency_bound


@pytest.mark.parametrize("which", ["weights", "extra_rates", "both"])
def test_weighted_and_background_folds_match(which, testbeds):
    ref_cl, cl = testbeds
    pi, _, lam = _plan(1)
    rng = np.random.default_rng(2)
    kw_np = {}
    if which in ("weights", "both"):
        kw_np["weights"] = rng.uniform(0.5, 4.0, lam.size).astype(np.float32)
    if which in ("extra_rates", "both"):
        kw_np["extra_rates"] = rng.uniform(0.0, 0.01, M).astype(np.float32)
    rkw = {k: jnp.asarray(v) for k, v in kw_np.items()}
    pkw = {k: _t(v) for k, v in kw_np.items()}
    ref_m, port_m = ref_cl.moments(CHUNK_MB), cl.moments(CHUNK_MB)
    z_ref = R.optimal_shared_z(jnp.asarray(pi), jnp.asarray(lam), ref_m, **rkw)
    z = P.optimal_shared_z(_t(pi), _t(lam), port_m, **pkw)
    _close(z, z_ref, rtol=1e-4)
    for zz in (z_ref, 5.0):
        _close(P.shared_z_latency(_t(pi), _t(zz), _t(lam), port_m, **pkw),
               R.shared_z_latency(jnp.asarray(pi), jnp.asarray(zz), jnp.asarray(lam),
                                  ref_m, **rkw))


def test_unit_weights_and_zero_background_are_the_plain_fold_bitwise(testbeds):
    _, cl = testbeds
    pi, _, lam = (_t(x) for x in _plan(3))
    m = cl.moments(CHUNK_MB)
    z = P.optimal_shared_z(pi, lam, m)
    for kw in ({"weights": torch.ones_like(lam)}, {"extra_rates": torch.zeros(M)}):
        assert torch.equal(P.optimal_shared_z(pi, lam, m, **kw), z)
        assert torch.equal(P.shared_z_latency(pi, z, lam, m, **kw),
                           P.shared_z_latency(pi, z, lam, m))


@pytest.mark.parametrize("deadline", [25.0, 45.0, 80.0])
def test_tail_probability_bounds_match(deadline, testbeds):
    ref_cl, cl = testbeds
    pi, _, lam = _plan(4)
    rates = lam @ pi
    eq, varq = R.pk_sojourn_moments(jnp.asarray(rates), ref_cl.moments(CHUNK_MB))
    d = np.full(lam.size, deadline, np.float32)
    want = R.tail_probability_bounds(jnp.asarray(pi), eq[None], varq[None], jnp.asarray(d))
    got = P.tail_probability_bounds(_t(pi), _t(eq)[None], _t(varq)[None], _t(d))
    _close(got, want)
    # a stacked batch keeps each instance's bracket
    got2 = P.tail_probability_bounds(
        torch.stack([_t(pi), _t(pi)]), torch.stack([_t(eq), 2 * _t(eq)])[:, None],
        torch.stack([_t(varq), _t(varq)])[:, None], _t(d), instance_ndim=2)
    assert torch.equal(got2[0], got)
    _close(got2[1], R.tail_probability_bounds(
        jnp.asarray(pi), 2 * eq[None], varq[None], jnp.asarray(d)))


# ------------------------------------------------------------- objectives


def test_make_objective_matches_and_validates():
    for args in [(CLASS_ID,), (CLASS_ID, (3.0, 1.0)), (CLASS_ID, (3.0, 1.0), (40.0, None)),
                 (CLASS_ID, None, (np.inf, 30.0), (0.0, 2.0))]:
        ref, port = R.make_objective(*args), P.make_objective(*args, device="cpu")
        for a, b in zip(port, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert port.n_classes == ref.n_classes
        assert port.class_id.dtype == torch.int64
    bad = [
        dict(class_id=[0, 1], weight=(1.0, -1.0)),
        dict(class_id=[0, 1], weight=(1.0,)),
        dict(class_id=[0, 2], weight=(1.0, 1.0)),
        dict(class_id=[0, 1], deadline=(0.0, 5.0)),
        dict(class_id=[0, 1], deadline=(5.0, 5.0), tail_weight=(1.0, -2.0)),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as ref_err:
            R.make_objective(**kw)
        with pytest.raises(ValueError) as err:
            P.make_objective(**kw, device="cpu")
        assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="both present"):
        P.ObjectiveSpec(class_id=torch.tensor([0, 1]), deadline=torch.ones(2)).validate()


def test_make_cache_spec_matches_and_validates():
    hit = [0.0, 0.5, 1.0, 0.25]
    ref, port = R.make_cache_spec(hit, 2.0, 3.0), P.make_cache_spec(hit, 2.0, 3.0, device="cpu")
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for args in [([[0.1]],), ([-0.1],), ([1.1],), ([0.1], -1.0), ([0.1], 0.0, -1.0)]:
        with pytest.raises(ValueError) as ref_err:
            R.make_cache_spec(*args)
        with pytest.raises(ValueError) as err:
            P.make_cache_spec(*args, device="cpu")
        assert str(err.value) == str(ref_err.value)


def _layer_inputs(seed=5):
    pi, _, lam = _plan(seed)
    r = lam.size
    cid = np.arange(r) % 3
    args = (cid, (4.0, 1.0, 2.0), (35.0, np.inf, 60.0), (10.0, 0.0, 3.0))
    hit = np.random.default_rng(seed).uniform(0.0, 0.6, r).astype(np.float32)
    bg = np.full(M, 0.003, np.float32)
    return pi, lam, args, hit, bg


@pytest.mark.parametrize("parts", ["spec", "spec+cache", "spec+background", "cache", "background"])
def test_composed_latency_refresh_and_reporting_match(parts, testbeds):
    ref_cl, cl = testbeds
    pi, lam, args, hit, bg = _layer_inputs()
    ref_m, port_m = ref_cl.moments(CHUNK_MB), cl.moments(CHUNK_MB)
    rkw, pkw = {}, {}
    rspec = pspec = None
    if "spec" in parts:
        rspec, pspec = R.make_objective(*args), P.make_objective(*args, device="cpu")
    if "cache" in parts:
        rkw["cache"] = R.make_cache_spec(hit, 2.0, 1.0)
        pkw["cache"] = P.make_cache_spec(hit, 2.0, 1.0, device="cpu")
    if "background" in parts:
        rkw["background"], pkw["background"] = jnp.asarray(bg), _t(bg)
    rpi, rlam, ppi, plam = jnp.asarray(pi), jnp.asarray(lam), _t(pi), _t(lam)
    z_ref = R.refresh_shared_z(rpi, rlam, ref_m, rspec, **rkw)
    z = P.refresh_shared_z(ppi, plam, port_m, pspec, **pkw)
    _close(z, z_ref, rtol=1e-4)
    _close(P.composed_latency(ppi, _t(z_ref), plam, port_m, pspec, **pkw),
           R.composed_latency(rpi, z_ref, rlam, ref_m, rspec, **rkw))
    # reporting: per-file bounds folded, class means and tails
    rc, pc = rkw.get("cache"), pkw.get("cache")
    lam_eff = lam * (1.0 - np.minimum(hit, 1 - 1e-6)) if rc is not None else lam
    rates = lam_eff @ pi + (bg if "background" in parts else 0.0)
    eq, varq = R.pk_sojourn_moments(jnp.asarray(rates, jnp.float32), ref_m)
    t = np.asarray(R.file_latency_bounds(rpi, eq[None], varq[None]))
    _close(P.compose_file_bounds(_t(t), ppi, _t(eq)[None], _t(varq)[None], plam, pspec, pc),
           R.compose_file_bounds(jnp.asarray(t), rpi, eq[None], varq[None], rlam, rspec, rc))
    if rspec is not None:
        _close(P.class_mean_bounds(_t(t), plam, pspec), R.class_mean_bounds(t, rlam, rspec))
        _close(P.class_tail_bounds(ppi, _t(eq)[None], _t(varq)[None], _t(lam_eff), pspec),
               R.class_tail_bounds(rpi, eq[None], varq[None], jnp.asarray(lam_eff), rspec),
               atol=1e-7)


def test_spec_without_tails_adds_no_tail_terms(testbeds):
    _, cl = testbeds
    pi, _, lam = _plan(6)
    spec = P.make_objective(np.arange(lam.size) % 2, (2.0, 1.0), device="cpu")
    m = cl.moments(CHUNK_MB)
    assert P.class_tail_bounds(_t(pi), None, None, _t(lam), spec) is None
    z = P.refresh_shared_z(_t(pi), _t(lam), m, spec)
    assert torch.equal(
        P.composed_latency(_t(pi), z, _t(lam), m, spec),
        P.shared_z_latency(_t(pi), z, _t(lam), m, weights=spec.file_weights()))


def _latencies(seed=0, n=5000, r=4):
    rng = np.random.default_rng(seed)
    lat = rng.gamma(3.0, 10.0, n).astype(np.float32)
    fid = rng.integers(0, r, n)
    valid = rng.random(n) > 0.2
    return lat, fid, valid


@pytest.mark.parametrize("spec_args", [None, (CLASS_ID, (3.0, 1.0)),
                                       (CLASS_ID, (3.0, 1.0), (45.0, None), (10.0, 0.0)),
                                       (CLASS_ID, None, (45.0, 30.0))])
def test_empirical_objective_host_and_device_match(spec_args):
    lat, fid, valid = _latencies()
    rspec = None if spec_args is None else R.make_objective(*spec_args)
    pspec = None if spec_args is None else P.make_objective(*spec_args, device="cpu")
    want = R.empirical_objective(lat, fid, rspec)
    assert P.empirical_objective(lat, fid, pspec) == pytest.approx(want, rel=1e-12)
    _close(P.empirical_objective_device(_t(lat), _t(fid, torch.int64), pspec),
           R.empirical_objective_device(jnp.asarray(lat), jnp.asarray(fid), rspec))
    _close(P.empirical_objective_device(_t(lat), _t(fid, torch.int64), pspec, _t(valid, torch.bool)),
           R.empirical_objective_device(jnp.asarray(lat), jnp.asarray(fid), rspec,
                                        jnp.asarray(valid)))
    # the device twin equals the host function on the same stream
    _close(P.empirical_objective_device(_t(lat), _t(fid, torch.int64), pspec),
           np.float32(P.empirical_objective(lat, fid, pspec)))


# ------------------------------------------------------------------- solves


def test_zero_cache_and_unit_cost_weights_solve_as_the_plain_problem():
    """``x * 1.0`` and ``x + 0.0`` are exact, forward and backward: these
    solve bit for bit as the plain problem."""
    _, port = _pair()
    plain = P.solve(port, max_iters=100)
    r = port.r
    for variant in (
        port._replace(cache=P.make_cache_spec(np.zeros(r), device="cpu")),
        port._replace(cost_weight=torch.ones(r)),
    ):
        _assert_bitwise(P.solve(variant, max_iters=100), plain)


def test_uniform_spec_solves_as_the_plain_problem():
    """A uniform spec's values equal the plain ones bit for bit at a fixed
    point; its gradient sums the fold's and the queues' parts of d/dpi in
    another order, so its solve holds the reference's own bound for this
    case (``tests/test_objectives.py::TestUniformEquivalence``: pi within
    1e-6, objective within rtol 1e-6, the same placement)."""
    _, port = _pair()
    plain = P.solve(port, max_iters=200)
    for cid in (CLASS_ID, [0] * port.r):
        spec = P.make_objective(cid, device="cpu")
        z = P.refresh_shared_z(plain.pi, port.lam, port.moments, spec)
        assert torch.equal(z, plain.z)
        assert torch.equal(P.composed_latency(plain.pi, z, port.lam, port.moments, spec),
                           plain.latency)
        uni = P.solve(port._replace(objective=spec), max_iters=200)
        np.testing.assert_allclose(uni.pi.numpy(), plain.pi.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(uni.objective), float(plain.objective), rtol=1e-6)
        np.testing.assert_array_equal(uni.placement.numpy(), plain.placement.numpy())
    assert uni.class_latency.shape == (1,) and uni.class_tail is None
    np.testing.assert_allclose(float(uni.class_latency[0]), float(uni.latency_tight), rtol=1e-6)


@pytest.mark.parametrize("objective", [
    (CLASS_ID, (4.0, 1.0)),
    (CLASS_ID, (1.0, 1.0), (35.0, None), (TAIL_WEIGHT, 0.0)),
])
def test_weighted_and_tail_solves_match_reference(objective):
    ref, port = _pair(objective)
    _assert_same_solution(P.solve(port, max_iters=300), R.solve(ref, max_iters=300))


def test_cache_and_cost_weight_solve_match_reference():
    hit = [0.4, 0.1, 0.0, 0.3]
    ref, port = _pair((CLASS_ID, (2.0, 1.0)))
    ref = ref._replace(cache=R.make_cache_spec(hit, 4.0, 6.0), cost_weight=jnp.asarray([3.0, 1.0, 2.0, 1.0]))
    port = port._replace(cache=P.make_cache_spec(hit, 4.0, 6.0, device="cpu"),
                         cost_weight=torch.tensor([3.0, 1.0, 2.0, 1.0]))
    _assert_same_solution(P.solve(port, max_iters=300), R.solve(ref, max_iters=300))
    ref_mec, mec = R.max_ec_solution(ref, max_iters=100), P.max_ec_solution(port, max_iters=100)
    _close(mec.cost, ref_mec.cost)
    _close(mec.objective, ref_mec.objective, rtol=1e-3)


def _quickstart(theta):
    ks = np.array([6.0, 7.0, 4.0], np.float32)
    lam = np.full(3, 0.125 / 3, np.float32)
    ref_cl, cl = ref_testbed(), tahoe_testbed(device="cpu")
    chunk = float(np.mean(200.0 / ks))
    return (R.JLCMProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks), moments=ref_cl.moments(chunk),
                          cost=ref_cl.cost, theta=theta),
            P.JLCMProblem(lam=_t(lam), k=_t(ks), moments=cl.moments(chunk), cost=cl.cost,
                          theta=theta))


@pytest.mark.parametrize("mode,theta,kw", [
    ("debug", 0.5, dict(max_iters=150)),
    ("debug", 200.0, dict(max_iters=150)),
    ("nested", 2.0, dict(max_iters=8, inner_steps=20)),
])
def test_debug_and_nested_modes_match_reference(mode, theta, kw, capsys):
    ref, port = _quickstart(theta)
    want = R.solve(ref, mode=mode, **kw)
    got = P.solve(port, mode=mode, verbose=True, **kw)
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    np.testing.assert_array_equal(got.placement.numpy(), np.asarray(want.placement))
    np.testing.assert_allclose(got.pi.numpy(), np.asarray(want.pi), atol=1e-3)
    for name in ("objective", "latency_tight"):
        _close(getattr(got, name), getattr(want, name), rtol=1e-3)
    assert int(got.iterations) == len(got.objective_trace) - 1
    assert int(got.iterations) == int(want.iterations)
    _close(got.objective_trace, want.objective_trace, rtol=1e-3)
    assert "[jlcm] iter    0" in capsys.readouterr().out
    if mode == "debug":  # the same algorithm as merged, host-driven
        merged = P.solve(port, **kw)
        np.testing.assert_allclose(float(got.objective), float(merged.objective), rtol=1e-5)


def test_solve_rejects_geo_with_background_and_unknown_modes():
    _, port = _pair()
    with pytest.raises(ValueError, match="unknown mode"):
        P.solve(port, mode="fast")
    geo = P.make_geo(port.moments._replace(
        mu=torch.stack([port.moments.mu] * 2), m2=torch.stack([port.moments.m2] * 2),
        m3=torch.stack([port.moments.m3] * 2)), np.full((4, 2), 0.5))
    with pytest.raises(ValueError, match="background"):
        P.solve(port._replace(geo=geo, background=torch.zeros(M)))


def test_stack_problems_rejects_mixed_objective_structure():
    ref_a, a = _pair((CLASS_ID, (2.0, 1.0)))
    ref_b, b = _pair((CLASS_ID, (2.0, 1.0), (40.0, None)))
    _, c = _pair()
    for probs in ([a, b], [a, c]):
        with pytest.raises(ValueError, match="objective"):
            P.stack_problems(probs)
    with pytest.raises(ValueError, match="objective"):
        R.stack_problems([ref_a, ref_b])
    stacked = P.stack_problems([a, a._replace(objective=P.make_objective(
        CLASS_ID, (5.0, 1.0), device="cpu"))])
    assert stacked.objective.weight.shape == (2, 2)
    assert stacked.objective.class_id.shape == (2, 4)
    assert stacked.objective.deadline is None


# ------------------------------------------------- tenant_tradeoff --smoke


SMOKE_WEIGHTS = (1.0, 2.0, 4.0)
SMOKE_DEADLINES = (float("inf"), 45.0)
SMOKE_REQUESTS = 6000


def _tenant_spec(w, d):
    """``make_objective``'s arguments at one point of the benchmark's grid."""
    return CLASS_ID, (w, 1.0), (d, None), (TAIL_WEIGHT if np.isfinite(d) else 0.0, 0.0)


@pytest.fixture(scope="module")
def tenant_smoke():
    grid = [(w, d) for d in SMOKE_DEADLINES for w in SMOKE_WEIGHTS]
    pairs = [_pair(_tenant_spec(w, d)) for w, d in grid]
    ref = R.solve_batch([p[0] for p in pairs], max_iters=400)
    port = P.solve_batch([p[1] for p in pairs], max_iters=400)
    return grid, pairs, ref, port


def test_tenant_batch_matches_reference_batch(tenant_smoke):
    grid, _, ref, port = tenant_smoke
    assert port.class_latency.shape == (len(grid), 2)
    for i in range(len(grid)):
        _assert_same_solution(
            type(port)(*(None if f is None else f[i] for f in port)),
            type(ref)(*(None if f is None else f[i] for f in ref)))


def test_tenant_batch_instance_equals_its_single_solve(tenant_smoke):
    grid, pairs, _, port = tenant_smoke
    for i in (len(grid) - 1,):  # the one with the most weight and a tail term
        single = P.solve(pairs[i][1], max_iters=400)
        np.testing.assert_allclose(port.pi[i].numpy(), single.pi.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(port.objective[i]), float(single.objective), rtol=1e-6)


def test_tenant_tradeoff_smoke_claims_on_the_reference_draws(tenant_smoke):
    """Each plan simulated on the reference run's own draws (key 0, as the
    benchmark's every point): per-class stats within rtol 1e-2 of the
    reference's run of its own plan (the plans differ by < 1e-3, so a
    Madow mask may flip), the empirical objective on device and host
    equal, and every assert of ``tenant_tradeoff.py`` on the port's
    numbers."""
    grid, _, ref, port = tenant_smoke
    ref_cl, cl = ref_testbed(), tahoe_testbed(device="cpu")
    lam = np.asarray(LAM, np.float32)
    key = jax.random.key(0)
    draws = _port_draws(_ref_draws(key, lam[None], SMOKE_REQUESTS, M))
    stats, premium = {}, {}
    warm = SMOKE_REQUESTS // 10
    for i, (w, d) in enumerate(grid):
        want = ref_sim.simulate(key, ref.pi[i], jnp.asarray(lam), ref_cl, CHUNK_MB, SMOKE_REQUESTS)
        got = simulate(None, port.pi[i], _t(lam), cl, CHUNK_MB, SMOKE_REQUESTS, draws=draws)
        flips = (madow_sample(draws.u, port.pi[i][draws.file_id])
                 != madow_sample(draws.u, _t(ref.pi[i])[draws.file_id])).any(-1)
        assert flips[warm:].float().mean() <= 1e-3
        st, st_ref = got.per_class_stats(np.asarray(CLASS_ID), 2), want.per_class_stats(
            np.asarray(CLASS_ID), 2)
        np.testing.assert_array_equal(st.count, st_ref.count)
        for name in ("mean", "p95", "p99"):
            np.testing.assert_allclose(getattr(st, name), getattr(st_ref, name), rtol=1e-2)
        spec = P.make_objective(*_tenant_spec(w, d), device="cpu")
        host = P.empirical_objective(got.latency, got.file_id, spec)
        _close(P.empirical_objective_device(got.latency, got.file_id, spec), np.float32(host))
        stats[(w, d)] = st
        lat, req_class = got.latency.numpy(), np.asarray(CLASS_ID)[got.file_id.numpy()]
        premium[(w, d)] = lat[req_class == 0]
    base, top = stats[(1.0, SMOKE_DEADLINES[0])], stats[(SMOKE_WEIGHTS[-1], SMOKE_DEADLINES[0])]
    i_base, i_top = grid.index((1.0, SMOKE_DEADLINES[0])), grid.index((SMOKE_WEIGHTS[-1], SMOKE_DEADLINES[0]))
    assert float(port.class_latency[i_top, 0]) < float(port.class_latency[i_base, 0])
    assert top.mean[0] < base.mean[0] and top.p99[0] < base.p99[0]
    d_t = SMOKE_DEADLINES[-1]
    exc_tail = float((premium[(1.0, d_t)] > d_t).mean())
    exc_mean = float((premium[(1.0, SMOKE_DEADLINES[0])] > d_t).mean())
    assert float(port.class_tail[grid.index((1.0, d_t)), 0]) >= exc_tail
    assert exc_tail < exc_mean
