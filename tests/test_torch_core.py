"""The port's core math and cluster model against the reference.

Inputs are made with numpy from a seed and handed to both packages as
float32. Closed forms and bisections are compared with ``assert_allclose``
at rtol 1e-5: both run in float32 (the reference with x64 off), but XLA
and PyTorch may sum a row in another order and evaluate sqrt/log with other
last-bit rounding, so results may differ by a few ulps (1e-5 is ~80 ulps
of float32). Madow sampling is compared exactly on the same uniforms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.latency_bound as ref_lb
import repro.core.projection as ref_proj
import repro.core.queueing as ref_q
import repro.core.scheduling as ref_sched
import repro_torch.core.latency_bound as lb
import repro_torch.core.projection as proj
import repro_torch.core.queueing as q
import repro_torch.core.scheduling as sched
from repro.storage import GeoFabric as RefGeoFabric
from repro.storage import tahoe_testbed as ref_testbed
from repro_torch.core import JLCMProblem, solve
from repro_torch.core.objectives import (
    apply_cache_thinning,
    compose_file_bounds,
    composed_latency,
    refresh_shared_z,
)
from repro_torch.storage import GeoFabric, simulate_fleet, tahoe_testbed
from repro_torch.storage import cluster as cluster_mod
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-5
M = 12


def _close(port, ref, **kw):
    np.testing.assert_allclose(
        port.numpy(), np.asarray(ref), rtol=kw.pop("rtol", RTOL), **kw
    )


def _feasible_pi(seed, r, m=M, ks=(1, 2, 4, 6, 7)):
    """Random feasible pi: random scores projected (by the reference) onto
    the capped simplex of random k's; includes k == 1 rows."""
    rng = np.random.default_rng(seed)
    k = rng.choice(ks, size=r).astype(np.float32)
    k[0] = 1.0
    v = rng.random((r, m)).astype(np.float32)
    pi = np.array(ref_proj.project_capped_simplex(jnp.asarray(v), jnp.asarray(k)))
    lam = (rng.random(r) * 0.02 / r + 1e-4).astype(np.float32)
    return pi, k, lam


@pytest.fixture(scope="module")
def moments():
    cl = ref_testbed()
    mom = cl.moments(33.3)
    return mom, q.ServiceMoments(*(torch.from_numpy(np.array(x)) for x in mom))


# --------------------------------------------------------------- queueing


def test_shifted_exponential_moments_match():
    rng = np.random.default_rng(0)
    d = rng.uniform(1, 10, M).astype(np.float32)
    rate = rng.uniform(0.01, 1, M).astype(np.float32)
    ref = ref_q.shifted_exponential_moments(jnp.asarray(d), jnp.asarray(rate))
    port = q.shifted_exponential_moments(torch.from_numpy(d), torch.from_numpy(rate))
    for a, b in zip(port, ref):
        assert a.dtype == torch.float32
        _close(a, b)
    _close(port.mean, ref.mean)
    _close(port.var, ref.var)


def test_float64_input_is_cast_to_float32():
    port = q.shifted_exponential_moments(np.array([2.0]), np.array([0.5]))
    assert all(x.dtype == torch.float32 for x in port)


@pytest.mark.parametrize("seed", [0, 1])
def test_pk_moments_rates_and_penalty_match(seed, moments):
    ref_m, port_m = moments
    pi, _, lam = _feasible_pi(seed, 40)
    lam = lam * 40.0  # push some queues toward the stability boundary
    ref_rates = ref_q.node_arrival_rates(jnp.asarray(pi), jnp.asarray(lam))
    rates = q.node_arrival_rates(torch.from_numpy(pi), torch.from_numpy(lam))
    _close(rates, ref_rates)
    _close(q.utilisation(rates, port_m), ref_q.utilisation(ref_rates, ref_m))
    for a, b in zip(
        q.pk_sojourn_moments(rates, port_m),
        ref_q.pk_sojourn_moments(ref_rates, ref_m),
    ):
        _close(a, b)
    hot = rates * 40.0  # beyond rho_max: the penalty is active
    _close(
        q.stability_penalty(hot, port_m),
        ref_q.stability_penalty(jnp.asarray(hot.numpy()), ref_m),
    )
    assert float(q.stability_penalty(hot, port_m)) > 0


# ------------------------------------------------------------- projection


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_matches(seed):
    rng = np.random.default_rng(seed)
    r = 30
    v = (rng.normal(size=(r, M)) * 2).astype(np.float32)
    mask = rng.random((r, M)) < 0.8
    mask[:, :7] = True  # every row allows at least k nodes
    k = rng.integers(1, 8, size=r).astype(np.float32)
    ref = ref_proj.project_capped_simplex(jnp.asarray(v), jnp.asarray(k), jnp.asarray(mask))
    port = proj.project_capped_simplex(
        torch.from_numpy(v), torch.from_numpy(k), torch.from_numpy(mask)
    )
    _close(port, ref, atol=1e-6)
    assert not port.numpy()[~mask].any()
    np.testing.assert_allclose(port.numpy().sum(-1), k, atol=1e-4)


def test_projection_without_mask_and_scalar_k():
    v = np.random.default_rng(3).normal(size=(5, 4, M)).astype(np.float32)
    ref = ref_proj.project_capped_simplex(jnp.asarray(v), 3.0)
    port = proj.project_capped_simplex(torch.from_numpy(v), 3.0)
    _close(port, ref, atol=1e-6)


def test_feasible_uniform_matches():
    mask = np.random.default_rng(4).random((10, M)) < 0.7
    mask[:, :7] = True
    k = np.arange(10, dtype=np.float32) % 7 + 1
    ref = ref_proj.feasible_uniform(jnp.asarray(mask), jnp.asarray(k))
    port = proj.feasible_uniform(torch.from_numpy(mask), torch.from_numpy(k))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ----------------------------------------------------------- latency bound


def _eq_varq(pi, lam, ref_m):
    eq, varq = ref_q.pk_sojourn_moments(
        ref_q.node_arrival_rates(jnp.asarray(pi), jnp.asarray(lam)), ref_m
    )
    return np.array(eq)[None, :], np.array(varq)[None, :]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimal_z_and_file_bounds_match(seed, moments):
    ref_m, _ = moments
    pi, _, lam = _feasible_pi(seed, 50)
    eq, varq = _eq_varq(pi, lam, ref_m)
    args_ref = [jnp.asarray(x) for x in (pi, eq, varq)]
    args = [torch.from_numpy(x) for x in (pi, eq, varq)]
    z_ref = ref_lb.optimal_z(*args_ref)
    z = lb.optimal_z(*args)
    # The bound is flat at its minimum, so the z where the float32
    # derivative changes sign moves by ~eps/curvature when a sum is taken
    # in another order: z agrees to rtol 1e-4, the bound at z to 1e-5.
    _close(z, z_ref, rtol=1e-4)
    # k == 1 rows sit at the bisection floor (-64 x scale), where Eq. (5)
    # cancels catastrophically; file_latency_bounds uses the closed form
    # there, so Eq. (5) itself is compared on the k > 1 rows.
    rows = pi.sum(-1) > 1.0 + ref_lb.K1_TOL
    _close(
        lb.bound_given_z(*args, z)[rows],
        np.asarray(ref_lb.bound_given_z(*args_ref, z_ref))[rows],
    )
    _close(lb.file_latency_bounds(*args), ref_lb.file_latency_bounds(*args_ref))


def test_optimal_z_scale_is_global_not_per_row():
    """One row with huge moments widens every row's bracket, as in the
    reference: the floor of a k == 1 row follows the global max."""
    pi = np.zeros((2, 3), np.float32)
    pi[:, 0] = 1.0
    eq = np.array([[1.0, 1.0, 1.0], [1000.0, 1.0, 1.0]], np.float32)
    varq = np.ones_like(eq)
    z = lb.optimal_z(*(torch.from_numpy(x) for x in (pi, eq, varq)))
    z_ref = ref_lb.optimal_z(*(jnp.asarray(x) for x in (pi, eq, varq)))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))
    assert z[0] == z[1] == -64.0 * (1000.0 + 1.0 + 1.0)


def test_bracket_fixed_compares_bits():
    a = torch.tensor([1.0, 0.0, float("nan")])
    assert proj.bracket_fixed(a[:2], a[:2], a[:2].clone(), a[:2].clone())
    assert not proj.bracket_fixed(a[:2], a[:2], a[:2] + 1e-7, a[:2])
    assert not proj.bracket_fixed(a[:2], a[:2], torch.tensor([1.0, -0.0]), a[:2])
    assert not proj.bracket_fixed(a, a, a.clone(), a.clone())  # a NaN is never fixed
    assert not proj.bracket_fixed(a.to("meta"), a.to("meta"), a.to("meta"), a.to("meta"))


@pytest.mark.parametrize("seed", [0, 1])
def test_bisections_stop_at_their_fixed_point_bit_for_bit(seed, moments, monkeypatch):
    """``optimal_z``, the projection, the tail bound's golden-section search
    and a whole JLCM solve on host tensors give the same bits whether they
    stop at the bracket's fixed point or run every step."""
    pi, k, lam = _feasible_pi(seed, 24)
    rng = np.random.default_rng(seed + 10)
    v = torch.from_numpy(rng.standard_normal((24, M)).astype(np.float32))
    mask = torch.from_numpy(rng.random((24, M)) < 0.8)
    mask[:, :8] = True
    pi_t, k_t, lam_t = map(torch.from_numpy, (pi, k, lam))
    mom = moments[1]
    eq, varq = q.pk_sojourn_moments(q.node_arrival_rates(pi_t, lam_t), mom)
    deadline = torch.full((24,), 3.0) * eq.max()
    prob = JLCMProblem(lam=lam_t * 50, k=torch.clamp(k_t, 2, 7), moments=mom,
                       cost=tahoe_testbed(device="cpu").cost, theta=0.5)

    def run():
        sol = solve(prob, max_iters=60)
        return (lb.optimal_z(pi_t, eq[None], varq[None]),
                proj.project_capped_simplex(v, k_t, mask),
                lb.tail_probability_bounds(pi_t, eq[None], varq[None], deadline),
                sol.pi, torch.as_tensor(sol.latency_tight), torch.as_tensor(sol.cost))

    stopped = run()
    monkeypatch.setattr(proj, "bracket_fixed", lambda *args: False)
    monkeypatch.setattr(lb, "bracket_fixed", lambda *args: False)
    for got, want in zip(stopped, run()):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_z_and_mean_bound_match(seed, moments):
    ref_m, port_m = moments
    pi, _, lam = _feasible_pi(seed, 64)
    pi_r, lam_r = jnp.asarray(pi), jnp.asarray(lam)
    pi_t, lam_t = torch.from_numpy(pi), torch.from_numpy(lam)
    z_ref = ref_lb.optimal_shared_z(pi_r, lam_r, ref_m)
    z = lb.optimal_shared_z(pi_t, lam_t, port_m)
    _close(z, z_ref, rtol=1e-4)  # flat minimum, see test_optimal_z_...
    _close(
        lb.shared_z_latency(pi_t, z, lam_t, port_m),
        ref_lb.shared_z_latency(pi_r, z_ref, lam_r, ref_m),
    )
    _close(
        lb.mean_latency_bound(pi_t, lam_t, port_m),
        ref_lb.mean_latency_bound(pi_r, lam_r, ref_m),
    )


def test_shared_z_is_batch_safe(moments):
    _, port_m = moments
    pis = [torch.from_numpy(_feasible_pi(s, 16)[0]) for s in (0, 1)]
    lam = torch.from_numpy(_feasible_pi(0, 16)[2])
    z = lb.optimal_shared_z(torch.stack(pis), lam, port_m)
    lat = lb.shared_z_latency(torch.stack(pis), z, lam, port_m)
    for i, p in enumerate(pis):
        torch.testing.assert_close(
            lat[i], lb.shared_z_latency(p, z[i], lam, port_m), rtol=RTOL, atol=0
        )


# --------------------------------------------------------------- objectives


def test_none_path_objectives_equal_latency_bound_functions(moments):
    _, port_m = moments
    pi, _, lam = _feasible_pi(5, 20)
    pi, lam = torch.from_numpy(pi), torch.from_numpy(lam)
    z = refresh_shared_z(pi, lam, port_m, None)
    assert torch.equal(z, lb.optimal_shared_z(pi, lam, port_m))
    assert torch.equal(
        composed_latency(pi, z, lam, port_m, None),
        lb.shared_z_latency(pi, z, lam, port_m),
    )
    assert apply_cache_thinning(lam, None) is lam
    t = torch.rand(20)
    torch.testing.assert_close(
        compose_file_bounds(t, pi, None, None, lam, None),
        (lam * t).sum() / lam.sum(),
    )


def _extras(r: int, seed: int = 7) -> dict:
    """Numpy inputs of a tenant spec, a geo spec (3 sites) and a cache spec
    for ``r`` files on M nodes."""
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, 2, r)
    cid[:2] = (0, 1)
    scale = np.array([10.0, 120.0, 2000.0], np.float32)[:, None, None]
    return dict(
        spec=(cid, (2.0, 1.0), (60.0, None), (5.0, 0.0)),
        hit=rng.uniform(0.0, 0.5, r).astype(np.float32),
        site=rng.uniform(0.5, 2.0, (3, 3, M)).astype(np.float32) * scale,
        mix=rng.dirichlet(np.ones(3), r).astype(np.float32),
    )


def _specs(extras: dict, pkg, moments_cls, tensor, **kw):
    """The (ObjectiveSpec, GeoSpec, CacheSpec) of ``extras`` built by one
    package (``kw`` carries the port's ``device``)."""
    m1, m2, m3 = (tensor(x) for x in extras["site"])
    return (
        pkg.make_objective(*extras["spec"], **kw),
        pkg.make_geo(moments_cls(1.0 / m1, m2, m3), extras["mix"]),
        pkg.make_cache_spec(extras["hit"], 3.0, 1.5, **kw),
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda mod, pi, lam, m, x: mod.composed_latency(pi, x["z"], lam, m, x["spec"]),
        lambda mod, pi, lam, m, x: mod.refresh_shared_z(pi, lam, m, None, geo=x["geo"]),
        lambda mod, pi, lam, m, x: mod.apply_cache_thinning(lam, x["cache"]),
        lambda mod, pi, lam, m, x: mod.compose_file_bounds(
            lam, pi, x["eq"], x["varq"], lam, x["spec"], x["cache"]),
    ],
)
def test_unported_objective_parts_raise(call, moments):
    """The objective layer's spec, geo and cache arguments, which raised
    before the layer was ported, now give the reference's values."""
    import repro.core as ref_core
    import repro.core.objectives as ref_obj
    import repro_torch.core as port_core
    import repro_torch.core.objectives as obj

    ref_m, port_m = moments
    pi, _, lam = _feasible_pi(6, 4)
    extras = _extras(4)
    rspec, rgeo, rcache = _specs(extras, ref_core, ref_q.ServiceMoments, jnp.asarray)
    pspec, pgeo, pcache = _specs(extras, port_core, q.ServiceMoments,
                                 torch.from_numpy, device="cpu")
    rates = lam @ pi
    eq, varq = ref_q.pk_sojourn_moments(jnp.asarray(rates), ref_m)
    ref = call(ref_obj, jnp.asarray(pi), jnp.asarray(lam), ref_m, dict(
        z=jnp.asarray(20.0), spec=rspec, geo=rgeo, cache=rcache,
        eq=eq[None], varq=varq[None]))
    port = call(obj, torch.from_numpy(pi), torch.from_numpy(lam), port_m, dict(
        z=torch.tensor(20.0), spec=pspec, geo=pgeo, cache=pcache,
        eq=torch.from_numpy(np.array(eq))[None], varq=torch.from_numpy(np.array(varq))[None]))
    _close(port, ref)


def _field_value(field: str, ref: bool):
    """A value of each optional problem field for a 2-file problem, built by
    the reference (``ref``) or the port from the same numbers."""
    import repro.core as ref_core
    import repro_torch.core as port_core

    pkg, kw = (ref_core, {}) if ref else (port_core, {"device": "cpu"})
    tensor = jnp.asarray if ref else torch.from_numpy
    if field == "cost_weight":
        return tensor(np.array([3.0, 1.0], np.float32))
    if field == "background":
        return tensor(np.full(M, 0.002, np.float32))
    if field == "cache":
        return pkg.make_cache_spec([0.3, 0.1], 2.0, 0.5, **kw)
    if field == "objective":
        return pkg.make_objective([0, 1], (3.0, 1.0), (80.0, None), **kw)
    mom = (ref_testbed() if ref else tahoe_testbed(device="cpu")).moments(33.3)
    site = type(mom)(*(tensor(np.stack([np.array(x), 1.3 * np.array(x)])) for x in mom))
    return pkg.make_geo(site, np.array([[0.7, 0.3], [0.2, 0.8]]))


@pytest.mark.parametrize(
    "field", ["objective", "geo", "cache", "cost_weight", "background"]
)
def test_unported_problem_fields_raise(field, moments):
    """Each optional problem field, which raised before it was ported, now
    solves to the reference's plan in merged and debug modes (identical n
    and placement, objective within rtol 1e-3)."""
    import repro.core as ref_core

    ref_m, port_m = moments
    ref_prob = ref_core.JLCMProblem(
        lam=jnp.full((2,), 0.01), k=jnp.full((2,), 4.0), moments=ref_m,
        cost=ref_testbed().cost, theta=1.0,
    )._replace(**{field: _field_value(field, ref=True)})
    prob = JLCMProblem(
        lam=torch.full((2,), 0.01), k=torch.full((2,), 4.0), moments=port_m,
        cost=tahoe_testbed(device="cpu").cost, theta=1.0,
    )._replace(**{field: _field_value(field, ref=False)})
    for mode in ("merged", "debug"):
        want = ref_core.solve(ref_prob, mode=mode, max_iters=60)
        got = solve(prob, mode=mode, max_iters=60)
        np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
        np.testing.assert_array_equal(got.placement.numpy(), np.asarray(want.placement))
        np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-3)


# ---------------------------------------------------------------- scheduling


@pytest.mark.parametrize("seed", [0, 1])
def test_madow_sample_exact_on_the_same_uniforms(seed):
    pi, k, _ = _feasible_pi(seed, 24)
    keys = jax.random.split(jax.random.key(seed), 200)
    for i in range(pi.shape[0]):
        ref = jax.vmap(lambda kk: ref_sched.madow_sample(kk, jnp.asarray(pi[i])))(keys)
        # scheduling.py draws u exactly so: uniform(key, (), pi.dtype)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float32))(keys)
        port = sched.madow_sample(
            torch.from_numpy(np.array(u)),
            torch.from_numpy(pi[i]).expand(200, M),
        )
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(port.numpy().sum(-1), np.rint(pi[i].sum()))


def test_madow_sample_batch_exact():
    pi, _, _ = _feasible_pi(3, 40)
    key = jax.random.key(7)
    ref = ref_sched.madow_sample_batch(key, jnp.asarray(pi))
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float32))(
        jax.random.split(key, pi.shape[0])
    )
    port = sched.madow_sample_batch(torch.from_numpy(np.array(u)), torch.from_numpy(pi))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        sched.madow_sample_batch(torch.zeros(3), torch.from_numpy(pi))


# ------------------------------------------------------------------ cluster


def test_testbed_tensors_match_reference():
    ref, cl = ref_testbed(), tahoe_testbed(device="cpu")
    assert cl.m == ref.m == M
    for name in ("overheads", "bandwidths"):
        np.testing.assert_array_equal(
            getattr(cl, name)().numpy(), np.asarray(getattr(ref, name)())
        )
    np.testing.assert_array_equal(cl.cost.numpy(), np.asarray(ref.cost))
    for a, b in zip(cl.moments(33.3), ref.moments(33.3)):
        _close(a, b)
    chunks = np.array([25.0, 50.0, 37.5], np.float32)
    d, rate = cl.service_params(torch.from_numpy(chunks)[:, None])
    d_r, rate_r = ref.service_params(jnp.asarray(chunks)[:, None])
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(rate_r))


def test_service_samplers_follow_the_moments():
    cl = tahoe_testbed(device="cpu")
    g = torch.Generator().manual_seed(0)
    x = cl.sample_service(g, 25.0, (40000,))
    mom = cl.moments(25.0)
    assert x.shape == (40000, M) and x.dtype == torch.float32
    np.testing.assert_allclose(x.mean(0).numpy(), mom.mean.numpy(), rtol=0.03)
    chunk = torch.full((30000,), 25.0)
    y = cl.sample_service_per_request(g, chunk, 30000)
    np.testing.assert_allclose(y.mean(0).numpy(), mom.mean.numpy(), rtol=0.03)
    assert (y >= cl.overheads()).all()


def test_single_site_fabric_is_the_cluster_exactly():
    cl = tahoe_testbed(device="cpu")
    fab = GeoFabric.single_site(cl)
    ref = RefGeoFabric.single_site(ref_testbed())
    assert fab.n_sites == 1 and fab.m == M
    d, rate = fab.service_params(40.0)
    d_r, rate_r = ref.service_params(40.0)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(rate_r))
    np.testing.assert_array_equal(d[0].numpy(), cl.overheads().numpy())
    np.testing.assert_array_equal(rate[0].numpy(), cl.service_params(40.0)[1].numpy())


def test_fabric_rejects_incomplete_site_profiles():
    cl = tahoe_testbed(device="cpu")
    bad = cluster_mod.ClientSite("x", {"NJ": 0.0}, {"NJ": 1.0})
    with pytest.raises(ValueError, match="lacks a profile"):
        GeoFabric(cl, (bad,))


# -------------------------------------------------------------- device rule


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Constructors default to the card and refuse to fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tahoe_testbed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tahoe_testbed(device="cuda")
    assert tahoe_testbed(device="cpu").device == torch.device("cpu")


def test_simulate_fleet_unported_options_raise():
    """The options that raised before the streaming fleet was ported now
    run, or raise the reference's ValueError; sharding seeds over several
    CUDA devices is the one left unported, and no CPU run reaches it."""
    fab = GeoFabric.single_site(tahoe_testbed(device="cpu"))
    pi = torch.full((2, M), 0.5)
    lam_cs = torch.full((1, 2), 0.01)
    g = torch.Generator().manual_seed(0)
    streamed = simulate_fleet(g, pi, lam_cs, fab, 10.0, 100, 2, stream=True)
    assert streamed.latency is None and int(streamed.stream.count.sum()) == 2 * 90
    chunked = simulate_fleet(g, pi, lam_cs, fab, 10.0, 100, 2, stream=True, n_chunks=2)
    assert chunked.windows.count.shape == (2, 2)
    cached = simulate_fleet(g, pi, lam_cs, fab, 10.0, 100, 2, cache_ttl=torch.ones(2))
    assert cached.hit.shape == (2, 90)
    with pytest.raises(ValueError, match="require stream=True"):
        simulate_fleet(g, pi, lam_cs, fab, 10.0, 100, 2, n_chunks=2)
    with pytest.raises(ValueError):
        simulate_fleet(g, pi, lam_cs, fab, 10.0, 100, 2, n_chunks=0)
