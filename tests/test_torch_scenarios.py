"""The port's scenario specs and the engine's open-loop policies against the
reference, on the CPU.

* Specs: the same 13 registered scenarios, field by field; every schedule
  and trace (availability, rates, drift, mixes, traffic matrices, egress,
  cache windows, file sizes), ``objective()``, ``cache_model()``,
  ``scaled``, ``diurnal_trace`` and ``hotspot_drift_hierarchical(r=2000)``
  bitwise; every ``validate`` / ``validate_geo_fabric`` rejection with the
  reference's message.
* ``initial_plan``, cache-aware and cache-blind, within the flat-valley
  tolerance of ``ROADMAP.md`` §C (support and bound held, pi to 2e-3).
* The open-loop policies (static on the reference's ``pi0``, oblivious on
  each package's own plan) of a plain, a repair, a cache and a geo
  scenario, on the reference's own draws: every segment's latencies equal
  the reference's up to the first flipped Madow set (``flips_of``), and
  with no flip the outcome's statistics are the reference's exactly.

* The closed loops (``node-failure``, ``cache-outage``, ``hotspot-drift``,
  ``premium-burst``, the hierarchical drift and ``geo-client-shift``), each
  in both packages on the reference's draws, held by
  ``assert_loop_tracks_reference`` (see the section's note), with the
  orderings and gates of ``tests/test_scenarios.py`` and
  ``benchmarks/scenario_suite.py``. They are in this module, which has many
  tests, so that pytest-xdist (which hands out modules with the most tests
  first) starts their minutes of solver work early rather than last.

The reference runs on its ``ref`` FCFS backend; no test launches a kernel.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as RSC
import repro.scenarios.engine as ref_engine
import repro.storage as RS
import repro_torch.scenarios as PSC
import repro_torch.scenarios.engine as port_engine
import repro_torch.storage as PS
from test_torch_segments import assert_stream_matches, flips_of, seg_draws, stack_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
PI_ATOL = 2e-3  # flat-valley stops (ROADMAP.md §C)


@pytest.fixture(scope="module")
def clusters():
    return RS.tahoe_testbed(), PS.tahoe_testbed(device="cpu")


@pytest.fixture(scope="module")
def fabrics(clusters):
    return RS.geo_testbed(), PS.geo_testbed(clusters[1])


# ----------------------------------------------------------- draw helpers


def ref_lam_seq(spec, placement0=None) -> list:
    """Each segment's draw rates as the reference's segment paths compute
    them: float32 rates times the segment's float32 scale, repair rows (at
    lam 1.0, scaled by the repair schedule) included; (C, r) rows for geo."""
    if spec.is_geo:
        return [jnp.asarray(x, jnp.float32) for x in spec.lam_cs_schedule()]
    r, s = spec.r, spec.n_segments
    lam = jnp.asarray(spec.lam, jnp.float32)
    scale = spec.rate_scales()[:, None] * np.ones((1, r))
    if spec.repair_rate > 0:
        lam_rep, _ = RS.repair_schedule(placement0, np.asarray(spec.k), spec.avail_trace(M),
                                        spec.repair_rate)
        lam = jnp.concatenate([lam, jnp.ones((r,), jnp.float32)])
        scale = np.concatenate([scale, lam_rep], axis=1)
    else:
        scale = spec.rate_scales()
    return [lam * jnp.asarray(scale[i], jnp.float32) for i in range(s)]


def ref_schedule_draws(spec, n, seed=0, placement0=None):
    """The reference's per-segment draws for ``seed``: segment s draws from
    ``split(key(seed), S)[s]`` (``simulate_segments`` and the closed loop's
    ``simulate_segment`` alike), at that segment's rates."""
    keys = jax.random.split(jax.random.key(seed), spec.n_segments)
    return stack_draws([seg_draws(k, lam, n, geo=spec.is_geo)
                        for k, lam in zip(keys, ref_lam_seq(spec, placement0))])


def ref_rollout_draws(spec, seed=0, n=600):
    """The reference's rollout draws: replan s rolls out on
    ``split(key(seed + 0x5EED), S)[s]``, unsplit (one draw), at the rates
    the replanner planned for, which the port hands to the callable."""
    keys = jax.random.split(jax.random.key(seed + 0x5EED), spec.n_segments)

    def draws(s, lam_cs):
        lam = jnp.asarray(lam_cs.numpy())
        return stack_draws([seg_draws(keys[s], lam if spec.is_geo else lam[0], n,
                                      geo=spec.is_geo)])
    return draws


def port_spec(name, factor, min_requests=200):
    return PSC.get_scenario(name).scaled(factor, min_requests=min_requests)


def ref_spec(name, factor, min_requests=200):
    return RSC.get_scenario(name).scaled(factor, min_requests=min_requests)


# ------------------------------------------------------------------- specs


def _array_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_registry_matches_reference_field_by_field():
    assert PSC.scenario_names() == RSC.scenario_names()
    assert len(PSC.scenario_names()) == 13
    names = [f.name for f in dataclasses.fields(PSC.ScenarioSpec)]
    assert names == [f.name for f in dataclasses.fields(RSC.ScenarioSpec)]
    for port, ref in zip(PSC.all_scenarios(), RSC.all_scenarios()):
        for name in names:
            assert getattr(port, name) == getattr(ref, name), (port.name, name)
        port.validate(M)
        for prop in ("r", "is_geo", "n_sites", "has_cache", "n_classes"):
            assert getattr(port, prop) == getattr(ref, prop), (port.name, prop)


@pytest.mark.parametrize("name", RSC.scenario_names())
def test_schedules_and_traces_are_bitwise(name, fabrics):
    port, ref = PSC.get_scenario(name), RSC.get_scenario(name)
    for method in ("avail_trace", "overhead_scales", "bandwidth_scales"):
        _array_equal(getattr(port, method)(M), getattr(ref, method)(M))
    for method in ("rate_scales", "mix_schedule", "lam_cs_schedule", "cache_up_trace",
                   "file_bytes"):
        _array_equal(getattr(port, method)(), getattr(ref, method)())
    if port.is_geo:
        port.validate_geo_fabric(fabrics[1])
        for got, want in zip(port.egress_scales(fabrics[1]), ref.egress_scales(fabrics[0])):
            _array_equal(got, want)
    got_obj, want_obj = port.objective(device="cpu"), ref.objective()
    assert (got_obj is None) == (want_obj is None)
    if want_obj is not None:
        for field in ("class_id", "weight", "deadline", "tail_weight"):
            got, want = getattr(got_obj, field), getattr(want_obj, field)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not port.has_cache:
        with pytest.raises(ValueError, match="no cache tier"):
            port.cache_model()
        return
    got_cm, want_cm = port.cache_model(), ref.cache_model()
    lam = np.asarray(port.lam, float)
    for method in ("ttl", "thin", "hit_rates"):
        _array_equal(getattr(got_cm, method)(lam), getattr(want_cm, method)(lam))
    assert got_cm.hot_cost() == want_cm.hot_cost()
    np.testing.assert_array_equal(got_cm.spec(lam, device="cpu").hit.numpy(),
                                  np.asarray(want_cm.spec(lam).hit))


def test_premium_burst_objective_and_scaled():
    obj = PSC.get_scenario("premium-burst").objective(device="cpu")
    np.testing.assert_array_equal(obj.class_id.numpy(), [0, 0, 1, 1])
    assert float(obj.weight[0]) > float(obj.weight[1])
    assert np.isfinite(float(obj.deadline[0])) and not np.isfinite(float(obj.deadline[1]))
    assert PSC.get_scenario("node-failure").objective(device="cpu") is None
    for factor, floor in ((0.1, 200), (0.15, 250), (0.4, 200), (0.2, 300)):
        for name in RSC.scenario_names():
            got = PSC.get_scenario(name).scaled(factor, min_requests=floor)
            want = RSC.get_scenario(name).scaled(factor, min_requests=floor)
            assert got.requests_per_segment == want.requests_per_segment
            assert got.failures == want.failures and got.n_segments == want.n_segments
    for n in (4, 8, 9):
        assert PSC.diurnal_trace(n) == RSC.diurnal_trace(n)
        assert PSC.diurnal_trace(n, 0.5, 2.0) == RSC.diurnal_trace(n, 0.5, 2.0)


def _malformed(pkg):
    get = pkg.get_scenario
    rep = dataclasses.replace
    steady, geo, cache = get("steady-state"), get("geo-client-shift"), get("cache-outage")
    return {
        "rate_trace_length": rep(steady, rate_trace=(1.0, 1.0)),
        "too_many_down": rep(steady, failures=tuple((j, 0, 3) for j in range(8))),
        "negative_repair": rep(steady, repair_rate=-0.1),
        "repair_without_failures": rep(steady, repair_rate=0.1),
        "node_out_of_range": rep(steady, failures=((12, 0, 1),)),
        "failure_window": rep(steady, failures=((0, 2, 9),)),
        "class_id_length": rep(get("premium-burst"), class_id=(0, 0, 1)),
        "class_weight_length": rep(get("premium-burst"), class_weight=(1.0, 2.0, 3.0)),
        "cache_negative": rep(cache, cache_hit_latency=-1.0),
        "file_mb_length": rep(cache, file_mb=(10.0, 10.0)),
        "file_mb_positive": rep(cache, file_mb=(10.0, 0.0, 10.0, 10.0)),
        "outage_without_cache": rep(steady, cache_outage=((1, 2),)),
        "cache_and_geo": rep(geo, cache_capacity_mb=50.0),
        "cache_and_repair": rep(cache, failures=((0, 1, 2),), repair_rate=0.1),
        "cache_window": rep(cache, cache_outage=((3, 12),)),
        "mix_without_sites": rep(steady, mix_trace=((1.0,),) * 4),
        "geo_and_classes": rep(geo, class_id=(0, 0, 1, 1)),
        "geo_and_drift": rep(geo, overhead_drift=(1.0,) * 8),
        "geo_and_repair": rep(geo, failures=((0, 1, 2),), repair_rate=0.1),
        "mix_shape": rep(geo, mix_trace=geo.mix_trace[:4]),
        "mix_not_a_distribution": rep(geo, mix_trace=((0.5, 0.1, 0.1, 0.1),) * 8),
        "egress_window": rep(geo, egress_degrade=(("NJ", 6, 9, 1.5, 0.7),)),
        "egress_must_slow": rep(geo, egress_degrade=(("NJ", 2, 5, 0.9, 0.7),)),
    }


@pytest.mark.parametrize("case", sorted(_malformed(RSC)))
def test_validate_rejects_like_the_reference(case):
    with pytest.raises(ValueError) as want:
        _malformed(RSC)[case].validate(M)
    with pytest.raises(ValueError) as got:
        _malformed(PSC)[case].validate(M)
    assert str(got.value) == str(want.value)


def test_geo_fabric_checks_and_registry_errors(fabrics):
    ref_fab, fab = fabrics
    geo = lambda pkg: pkg.get_scenario("cross-site-outage")
    cases = [
        lambda pkg: pkg.get_scenario("steady-state"),
        lambda pkg: dataclasses.replace(geo(pkg), sites=("NJ", "TX", "CA", "XX")),
        lambda pkg: dataclasses.replace(geo(pkg), egress_degrade=(("XX", 2, 5, 1.5, 0.7),)),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(RSC).validate_geo_fabric(ref_fab)
        with pytest.raises(ValueError) as got:
            case(PSC).validate_geo_fabric(fab)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="unknown scenario"):
        PSC.get_scenario("no-such-scenario")
    with pytest.raises(ValueError, match="already registered"):
        PSC.register(PSC.get_scenario("steady-state"))
    with pytest.raises(ValueError, match="unknown policy"):
        PSC.run_scenario(PSC.get_scenario("steady-state"), "clairvoyant")


def test_hotspot_drift_hierarchical_is_bitwise():
    spec, h = PSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    want_spec, want_h = RSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    for f in dataclasses.fields(want_spec):
        assert getattr(spec, f.name) == getattr(want_spec, f.name), f.name
    for got, want in zip(h, want_h):
        _array_equal(got, want)
    assert len(spec.lam) == 2000 and h.n_clusters < 200 and int(h.counts.sum()) == 2000
    bad = dataclasses.replace(spec, failures=((0, 2, 3),), repair_rate=0.1)
    with pytest.raises(ValueError, match="hierarch"):
        PSC.run_scenario(bad, "adaptive", seed=0, hierarchy=h,
                         cluster=PS.tahoe_testbed(device="cpu"))


# ------------------------------------------------------------ initial plans


@pytest.mark.parametrize("name,cache_aware", [
    ("node-failure", True), ("premium-burst", True), ("cache-outage", True),
    ("cache-outage", False)])
def test_initial_plan_matches_reference(name, cache_aware, clusters):
    ref_cl, cl = clusters
    spec_p, spec_r = PSC.get_scenario(name), RSC.get_scenario(name)
    got_pi, got_mom, got = PSC.initial_plan(spec_p, cl, cache_aware=cache_aware)
    want_pi, _, want = RSC.initial_plan(spec_r, ref_cl, cache_aware=cache_aware)
    assert isinstance(got_pi, np.ndarray) and got_pi.shape == (4, M)
    np.testing.assert_allclose(got_pi, np.asarray(want_pi), atol=PI_ATOL)
    np.testing.assert_array_equal(got.placement.numpy(), np.asarray(want.placement))
    np.testing.assert_allclose(float(got.latency_tight), float(want.latency_tight), rtol=1e-4)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-4)
    np.testing.assert_allclose(got_mom.mu.numpy(), np.asarray(ref_cl.moments(12.5).mu))
    np.testing.assert_allclose(PSC.oblivious_plan(spec_p, cl),
                               np.asarray(RSC.oblivious_plan(spec_r, ref_cl)), atol=1e-6)


# ---------------------------------------------------- open-loop policies


OPEN_LOOP_CASES = {
    # (scenario, scale, min requests): a plain, a repair, a cache and a geo one
    "plain": ("node-failure", 0.4, 200),
    "repair": ("node-failure-repair", 0.4, 200),
    "cache": ("cache-outage", 0.2, 300),
    "geo": ("geo-client-shift", 0.2, 300),
}


def _ref_initial(spec, ref_cl):
    if spec.is_geo:
        pi0, _, sol0 = RSC.initial_plan(spec, RS.geo_testbed(ref_cl).cluster)
    else:
        pi0, _, sol0 = RSC.initial_plan(spec, ref_cl)
    return np.asarray(pi0), np.asarray(sol0.placement, bool)


def _segment_plans(spec, pi, placement0):
    """The (S, rows, m) plan each segment dispatched on: the client plan
    with the schedule's repair rows below it."""
    if spec.repair_rate <= 0:
        return np.broadcast_to(pi, (spec.n_segments,) + pi.shape)
    _, pi_rep = RS.repair_schedule(placement0, np.asarray(spec.k), spec.avail_trace(M),
                                   spec.repair_rate)
    return np.stack([np.concatenate([pi, pi_rep[s]]) for s in range(spec.n_segments)])


@pytest.mark.parametrize("case", sorted(OPEN_LOOP_CASES))
@pytest.mark.parametrize("policy", ["static", "oblivious"])
def test_open_loop_policies_match_reference_on_its_draws(case, policy, clusters):
    name, factor, floor = OPEN_LOOP_CASES[case]
    spec_r, spec_p = ref_spec(name, factor, floor), port_spec(name, factor, floor)
    ref_cl, cl = clusters
    pi0, placement0 = _ref_initial(spec_r, ref_cl)
    kw = dict(seed=0, pi0=None if policy == "oblivious" else pi0)
    if not spec_r.is_geo:
        kw["placement0"] = placement0
    sim = "simulate_geo_segments" if spec_r.is_geo else "simulate_segments"
    with calls_of(ref_engine, sim) as ref_runs:
        want = RSC.run_scenario(spec_r, policy, **kw)
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment, placement0=placement0)
    with calls_of(port_engine, sim) as port_runs:
        got = PSC.run_scenario(spec_p, policy, cluster=cl, draws=draws, **kw)
    if policy == "oblivious":
        obl = PSC.oblivious_plan(spec_p, cl)
        want_pi, got_pi = np.asarray(RSC.oblivious_plan(spec_r, ref_cl)), obl
    else:
        want_pi = got_pi = pi0
    flips = torch.stack([
        flips_of(draws.at(s), p, q) for s, (p, q) in enumerate(zip(
            _segment_plans(spec_r, got_pi, placement0),
            _segment_plans(spec_r, want_pi, placement0)))])
    assert_stream_matches(port_runs[0][2], ref_runs[0][2], flips)
    assert got.policy == want.policy and got.replans == want.replans == 0
    assert got.solve_iters == () and got.row()["solve_iters"] == ""
    assert got.seg_mean.shape == (spec_r.n_segments,)
    assert (got.site_mean is None) == (want.site_mean is None)
    if flips.any():  # stats hold exactly only on identical streams
        np.testing.assert_allclose(got.mean, want.mean, rtol=5e-3)
        return
    for field in ("seg_mean", "seg_p99", "mean", "p99", "degraded_frac", "repair_frac",
                  "hit_frac", "storage_cost", "site_mean"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.row() == want.row()


# ------------------------------------------- closed-loop helpers (shared)


@contextlib.contextmanager
def calls_of(module, name: str):
    """Record every call to ``module.name``: its arguments and result."""
    fn = getattr(module, name)
    out = []

    def recorder(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append((args, kwargs, res))
        return res

    setattr(module, name, recorder)
    try:
        yield out
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def replan_log(module, name: str, segments: list):
    """Swap ``module.name`` (a replanner class) for a subclass that logs each
    replan's candidate scores, chosen plan, iterations and the segment its
    plan first runs in (``segments``: the segment calls recorded so far)."""
    base = getattr(module, name)
    log = []

    class Logged(base):
        def replan(self, *args, **kwargs):
            pi = super().replan(*args, **kwargs)
            scores = getattr(self, "last_scores", None)
            log.append(dict(pi=np.asarray(pi), iters=self.solve_iters[-1], segment=len(segments),
                            scores=None if scores is None else np.asarray(scores)))
            return pi

    setattr(module, name, Logged)
    try:
        yield log
    finally:
        setattr(module, name, base)


def _replanner_name(spec, hierarchy):
    if hierarchy is not None:
        return "HierarchicalReplanner"
    return "GeoAdaptiveReplanner" if spec.is_geo else "AdaptiveReplanner"


def closed_loop_pair(spec_r, spec_p, clusters, *, hierarchy=None, cache_aware=True):
    """The adaptive policy in both packages on the reference's draws, the
    segment draws and the rollout draws alike. Without a hierarchy both
    start from the reference's initial plan (``pi0``, ``placement0``);
    with one, each solves its own cluster-granularity plan (the seeded
    incumbent needs it). Returns the outcomes, each replan's log and each
    segment's (plan, result)."""
    ref_cl, cl = clusters
    kw, placement0 = dict(seed=0, cache_aware=cache_aware), None
    if hierarchy is None:
        pi0, placement0 = _ref_initial(spec_r, ref_cl)
        kw["pi0"] = pi0
        if not spec_r.is_geo:
            kw["placement0"] = placement0
    sim = "simulate_geo_segment" if spec_r.is_geo else "simulate_segment"
    rp = _replanner_name(spec_r, hierarchy)
    ref_h, port_h = (None, None) if hierarchy is None else hierarchy
    with calls_of(ref_engine, sim) as ref_segs, replan_log(ref_engine, rp, ref_segs) as ref_log:
        want = RSC.run_scenario(spec_r, "adaptive", hierarchy=ref_h, **kw)
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment, placement0=placement0)
    with calls_of(port_engine, sim) as port_segs, \
            replan_log(port_engine, rp, port_segs) as port_log:
        got = PSC.run_scenario(spec_p, "adaptive", cluster=clusters[1], hierarchy=port_h,
                               draws=draws, rollout_draws=ref_rollout_draws(spec_r), **kw)
    plans = lambda segs: [np.asarray(args[1]) for args, _, _ in segs]
    results = lambda segs: [res[0] for _, _, res in segs]
    return dict(want=want, got=got, ref_log=ref_log, port_log=port_log, draws=draws,
                ref_plans=plans(ref_segs), port_plans=plans(port_segs),
                ref_res=results(ref_segs), port_res=results(port_segs))


FLIP_RTOL = 1e-2  # of a segment's clients' mean, per Madow set flipped in it; see below
FLIP_RTOL_CAP = 5e-2


def assert_loop_tracks_reference(pair, first_replan=True):
    """The closed loop held to the reference's.

    * Replan count, telemetry lengths and, with ``first_replan``, the first
      replan's chosen candidate (exactly) and plan (to 2e-3, the solver's
      flat-valley stops, ``ROADMAP.md`` §C).
    * Per segment: the Madow sets both packages' deployed plans draw on the
      same uniforms are compared (``flips_of``). Until the first flipped
      set of the run, every segment's latencies equal the reference's
      bitwise. After it, a segment's clients' mean is held to
      ``FLIP_RTOL`` times the sets flipped in that segment, at most
      ``FLIP_RTOL_CAP``. A flipped set moves one chunk read (service ~14 s
      at 12.5 MB, up to ~30 s on a drifted node) to another node; that
      shifts the waits of the requests queued behind it on those two nodes
      until their queues drain, about 1 / (1 - rho) requests, 5 at the
      busiest nodes' rho of 0.8: 5 x 30 s over a segment of 800 requests
      with a mean of ~19 s is 1e-2 of the mean a flip, and it drains inside
      its own segment.
    * Where a replan picks another candidate than the reference's, the two
      loops deploy different plans: the segments that run that replan's
      plan are not compared by mean (their file ids, drawn before any
      plan, still are). A later replan that picks the reference's
      candidate again is held again from its first segment.

    Returns each segment's flip count.
    """
    want, got = pair["want"], pair["got"]
    assert got.replans == want.replans > 0
    for field in ("solve_iters", "solve_walls", "rollout_walls", "resolved_counts"):
        assert len(getattr(got, field)) == len(getattr(want, field)), field
    assert all(int(v) >= 1 for v in got.solve_iters) and all(v > 0 for v in got.solve_walls)
    row = got.row()
    assert row["solve_iters"].count("|") == got.replans - 1
    assert len(pair["port_log"]) == len(pair["ref_log"]) == got.replans
    if first_replan:
        ref0, port0 = pair["ref_log"][0], pair["port_log"][0]
        if ref0["scores"] is not None:
            assert int(np.argmin(port0["scores"])) == int(np.argmin(ref0["scores"]))
        np.testing.assert_allclose(port0["pi"], ref0["pi"], atol=PI_ATOL)
    # the segments that run the plan of a replan which chose another candidate
    chose = {ref["segment"]: int(np.argmin(port["scores"])) != int(np.argmin(ref["scores"]))
             for ref, port in zip(pair["ref_log"], pair["port_log"]) if ref["scores"] is not None}
    flips, flipped, apart = [], False, False
    for s, (p, q, res_p, res_r) in enumerate(zip(pair["port_plans"], pair["ref_plans"],
                                                 pair["port_res"], pair["ref_res"])):
        apart = chose.get(s, apart)
        flips.append(int(flips_of(pair["draws"].at(s), p, q).sum()))
        flipped = flipped or flips[-1] > 0
        lat, want_lat = res_p.latency.numpy(), np.asarray(res_r.latency)
        np.testing.assert_array_equal(res_p.file_id.numpy(), np.asarray(res_r.file_id))
        if not flipped:
            np.testing.assert_array_equal(lat, want_lat, err_msg=f"segment {s}")
        elif not apart:
            np.testing.assert_allclose(got.seg_mean[s], want.seg_mean[s],
                                       rtol=min(FLIP_RTOL * flips[-1], FLIP_RTOL_CAP),
                                       err_msg=f"segment {s}, {flips[-1]} flips")
    return flips


@pytest.mark.parametrize("name", ["node-failure", "cache-outage", "geo-client-shift"])
def test_seeded_generator_draws_are_reproducible(name, clusters):
    """Without explicit draws the engine draws every segment from a
    generator seeded with ``seed``: the same seed gives the same run, bit
    for bit, another seed another one."""
    spec = port_spec(name, 0.1)
    run = lambda seed: PSC.run_scenario(spec, "oblivious", seed=seed, cluster=clusters[1])
    first, again, other = run(3), run(3), run(4)
    np.testing.assert_array_equal(first.seg_mean, again.seg_mean)
    assert first.row() == again.row()
    assert not np.array_equal(first.seg_mean, other.seg_mean)
    assert np.isfinite(first.mean) and first.seg_mean.shape == (spec.n_segments,)


# ------------------------------------------------------------ closed loops
#
# Each closed loop runs in both packages on the reference's draws (segments
# and rollouts alike) through ``closed_loop_pair`` and is held by
# ``assert_loop_tracks_reference``: the replan count, the telemetry, the
# first replan's choice and plan, each segment's latencies bitwise until
# the first flipped Madow set and its clients' mean within a flip-scaled
# tolerance after it (a plan that differs in the last bit can flip a set
# and move later replans, ``ROADMAP.md`` §C), beside the orderings the
# reference's own tests assert.
#
# node-failure scaled 0.4 (tests/test_scenarios.py's size): the dense
# AdaptiveReplanner with rollouts from the live carry, beside the static and
# oblivious policies on the same draws.


@pytest.fixture(scope="module")
def failure(clusters):
    spec_r, spec_p = ref_spec("node-failure", 0.4), port_spec("node-failure", 0.4)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, placement0 = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    open_loop = {p: PSC.run_scenario(spec_p, p, cluster=clusters[1], draws=draws,
                                     pi0=None if p == "oblivious" else pi0,
                                     placement0=placement0)
                 for p in ("static", "oblivious")}
    return pair, {**open_loop, "adaptive": pair["got"]}


def test_node_failure_adaptive_tracks_reference(failure):
    pair, _ = failure
    assert pair["got"].seg_mean.shape == (8,)
    assert_loop_tracks_reference(pair)


def test_node_failure_orderings(failure):
    """tests/test_scenarios.py::TestClosedLoop's claims on the port."""
    _, out = failure
    for o in out.values():
        assert np.isfinite(o.mean) and np.isfinite(o.p99)
    assert out["adaptive"].mean < out["oblivious"].mean
    assert out["adaptive"].mean < out["static"].mean
    assert out["adaptive"].degraded_frac < 0.01 and out["static"].degraded_frac > 0.1
    assert out["adaptive"].replans > 0 and out["static"].replans == 0
    assert out["static"].solve_iters == () and out["static"].row()["solve_iters"] == ""


# cache-outage scaled 0.2, at least 300 requests a segment: the adaptive
# loop feeds its rate estimator miss traffic, inverts it through the deployed
# TTLs, re-derives TTLs, is forced to re-plan when the hot tier goes down and
# comes back, and holds the storm plan through the outage; held with the hot
# tier's hit share and storage cost, and with benchmarks/scenario_suite.py's
# gate (adaptive below the cache-blind static baseline on mean and windowed
# p99, at no more storage cost).


@pytest.fixture(scope="module")
def outage(clusters):
    spec_r, spec_p = ref_spec("cache-outage", 0.2, 300), port_spec("cache-outage", 0.2, 300)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    _, placement0 = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    blind = PSC.run_scenario(spec_p, "static", cluster=clusters[1], placement0=placement0,
                             cache_aware=False, draws=draws)
    want_blind = RSC.run_scenario(spec_r, "static", seed=0, placement0=placement0,
                                  cache_aware=False)
    return pair, blind, want_blind


def test_cache_outage_tracks_reference(outage):
    pair, _, _ = outage
    assert_loop_tracks_reference(pair)
    got, want = pair["got"], pair["want"]
    # one replan a segment boundary outside the outage, the forced one at each
    # hot-tier flip, none inside it (the storm plan is held)
    assert got.replans == 6
    np.testing.assert_allclose(got.hit_frac, want.hit_frac, rtol=1e-3)
    np.testing.assert_allclose(got.storage_cost, want.storage_cost, rtol=1e-3)


def test_cache_blind_baseline_and_gate(outage):
    pair, blind, want_blind = outage
    ada = pair["got"]
    assert blind.policy == want_blind.policy == "static-cacheblind"
    np.testing.assert_allclose(blind.mean, want_blind.mean, rtol=1e-2)
    np.testing.assert_allclose(blind.storage_cost, want_blind.storage_cost, rtol=1e-3)
    assert ada.mean < blind.mean and ada.p99_windowed < blind.p99_windowed
    assert ada.storage_cost <= blind.storage_cost
    assert 0.0 < ada.hit_frac < 1.0


# hotspot-drift scaled 0.4 (tests/test_scenarios.py's TestSolverTelemetry
# size), adaptive and static, with the telemetry the reference's test asserts.


@pytest.fixture(scope="module")
def drift(clusters):
    spec_r, spec_p = ref_spec("hotspot-drift", 0.4), port_spec("hotspot-drift", 0.4)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, placement0 = _ref_initial(spec_r, clusters[0])
    static = PSC.run_scenario(spec_p, "static", cluster=clusters[1], pi0=pi0,
                              placement0=placement0,
                              draws=ref_schedule_draws(spec_r, spec_r.requests_per_segment))
    return pair, static


def test_hotspot_drift_tracks_reference(drift):
    pair, _ = drift
    assert_loop_tracks_reference(pair)


def test_adaptive_records_iters_and_walls(drift):
    pair, static = drift
    out = pair["got"]
    assert out.replans > 0
    assert len(out.solve_iters) == len(out.solve_walls) == len(out.rollout_walls) == out.replans
    assert all(int(v) >= 1 for v in out.solve_iters) and all(v > 0.0 for v in out.solve_walls)
    row = out.row()
    assert row["solve_iters"].count("|") == out.replans - 1
    assert row["solve_wall_ms"].count("|") == out.replans - 1
    assert static.replans == 0 and static.solve_iters == () and static.solve_walls == ()
    assert static.row()["solve_iters"] == ""
    assert np.isfinite(out.mean) and np.isfinite(static.mean)


# premium-burst scaled 0.15, at least 250 requests a segment
# (tests/test_scenarios.py's TestMultiTenant size): the composed objective
# (class weights and a premium tail deadline) in every solve and rollout
# score. The reference fails two of TestMultiTenant's claims at this size
# (test_weighted_plan_protects_premium_class,
# test_adaptive_tracks_burst_no_worse_than_oblivious; ROADMAP.md §C), so the
# port is held to the reference's per-class outputs, not to those claims.


@pytest.fixture(scope="module")
def burst(clusters):
    spec_r = ref_spec("premium-burst", 0.15, 250)
    spec_p = port_spec("premium-burst", 0.15, 250)
    return closed_loop_pair(spec_r, spec_p, clusters)


def test_premium_burst_tracks_reference(burst):
    assert_loop_tracks_reference(burst)


def test_class_stats_match_reference(burst):
    got, want = burst["got"], burst["want"]
    assert got.class_mean.shape == got.class_p99.shape == (2,)
    assert np.isfinite(got.class_mean).all() and np.isfinite(got.class_p99).all()
    assert "class_means" in got.row() and "class_p99s" in got.row()
    if got.mean == want.mean:  # the same stream end to end
        np.testing.assert_array_equal(got.class_mean, want.class_mean)
        np.testing.assert_array_equal(got.class_p99, want.class_p99)
    else:
        np.testing.assert_allclose(got.class_mean, want.class_mean, rtol=5e-2)


# hotspot_drift_hierarchical at r = 2000 and 800 requests a segment
# (tests/test_scenarios.py's size; HierarchicalReplanner: full re-solves on
# moment drift, incremental ones otherwise) and geo-client-shift scaled 0.2
# (GeoAdaptiveReplanner with geo rollouts), with the orderings the
# reference's tests and benchmarks/scenario_suite.py assert. The geo loop
# parts from the reference's at its third replan: the geo solves stop in a
# flat valley (pi 2.3e-2 apart there, ROADMAP.md §C), and Madow sets flip
# from then on (2, 85 and 6 in segments 3-5, each segment's mean within 1e-2
# a flip of the reference's). The sixth replan picks the other candidate, so
# segment 6 is not compared by mean; the seventh picks the reference's
# again, and segment 7 is held.


@pytest.fixture(scope="module")
def hierarchical(clusters):
    ref = RSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    port = PSC.hotspot_drift_hierarchical(r=2000, requests_per_segment=800)
    pair = closed_loop_pair(ref[0], port[0], clusters, hierarchy=(ref[1], port[1]))
    draws = ref_schedule_draws(ref[0], 800)
    static = PSC.run_scenario(port[0], "static", seed=0, cluster=clusters[1],
                              hierarchy=port[1], draws=draws)
    want_static = RSC.run_scenario(ref[0], "static", seed=0, hierarchy=ref[1])
    return pair, static, want_static


def test_hierarchical_loop_tracks_reference(hierarchical):
    pair, static, want_static = hierarchical
    got, want = pair["got"], pair["want"]
    assert got.resolved_counts == want.resolved_counts
    assert_loop_tracks_reference(pair)
    # the static plans are the two packages' own cluster solves
    np.testing.assert_allclose(static.mean, want_static.mean, rtol=1e-2)


def test_hierarchical_orderings_and_telemetry(hierarchical):
    """tests/test_scenarios.py::TestHierarchicalScenario's claims."""
    pair, static, _ = hierarchical
    o = pair["got"]
    assert np.isfinite(o.mean) and np.isfinite(o.p99) and np.isfinite(static.mean)
    assert o.mean < static.mean
    assert o.replans > 0
    assert len(o.solve_iters) == len(o.solve_walls) == len(o.resolved_counts) == o.replans
    assert o.rollout_walls == ()
    row = o.row()
    assert "resolved_clusters" in row and row["solve_iters"].count("|") == o.replans - 1


@pytest.fixture(scope="module")
def geo(clusters):
    spec_r, spec_p = ref_spec("geo-client-shift", 0.2, 300), port_spec("geo-client-shift", 0.2, 300)
    pair = closed_loop_pair(spec_r, spec_p, clusters)
    pi0, _ = _ref_initial(spec_r, clusters[0])
    draws = ref_schedule_draws(spec_r, spec_r.requests_per_segment)
    static = PSC.run_scenario(spec_p, "static", cluster=clusters[1], pi0=pi0, draws=draws)
    return pair, static


def test_geo_loop_tracks_reference(geo):
    pair, _ = geo
    assert_loop_tracks_reference(pair)
    got, want = pair["got"], pair["want"]
    assert got.site_mean.shape == want.site_mean.shape == (4,)
    assert len(got.rollout_walls) == got.replans


def test_geo_orderings(geo):
    """scenario_suite.py's geo-client-shift gate: replans, and adaptive's
    mean below the static geo-oblivious plan's."""
    pair, static = geo
    ada = pair["got"]
    assert ada.replans > 0 and static.replans == 0
    assert ada.mean < static.mean
    assert np.isfinite(ada.site_mean).all() and np.isfinite(static.site_mean).all()
