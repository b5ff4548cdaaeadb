"""The port's streaming latency statistics and the simulator's reporting
surfaces against the reference, on the CPU.

* ``storage/streaming.py`` on numpy inputs from a seed, with batch shapes
  (), (S,) and (S, W), ``include=`` masks and values outside the sketch's
  regular range: ``count``, ``hist``, ``minv`` and ``maxv`` equal the
  reference's exactly (integer counts and float32 comparisons);
  ``mean``, ``m2``, ``stream_var`` and ``stream_quantile`` within rtol
  1e-5 (float32 sums in another order). ``stream_merge`` and
  ``stream_reduce`` the same way. The port is held to the reference's
  outputs, not to the merge-order property that
  ``tests/test_streaming.py::TestProperties::test_merge_order_invariant``
  asserts and the reference fails.
* ``simulate(sketch=...)`` on the reference's own draws, rebuilt by
  ``tests/test_torch_slice.py``'s helpers: the stream equals the
  reference's.
* ``per_class_latency_stats`` and ``simulate_latency_cdf``: rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _port_draws, _ref_draws, _ref_masks

import repro.storage.simulator as ref_sim
import repro.storage.streaming as ref_st
import repro_torch.storage.streaming as st
from repro.core import JLCMProblem as RefProblem
from repro.core import solve as ref_solve
from repro.storage import tahoe_testbed as ref_testbed
from repro_torch.core.scheduling import madow_sample
from repro_torch.storage import (
    per_class_latency_stats,
    simulate,
    simulate_latency_cdf,
    tahoe_testbed,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-5
EXACT = ("count", "hist", "minv", "maxv")
SPECS = [st.DEFAULT_SKETCH, st.SketchSpec(lo=0.5, hi=400.0, bins=64)]


def _values(seed, shape):
    """Latency-like values over several decades, some below 1e-3 and above
    1e4 (the default sketch's clamp buckets)."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(2.0, 3.0, shape)).astype(np.float32)


def _include(seed, shape):
    return np.random.default_rng(seed + 100).random(shape) < 0.8


def _assert_same_stats(port, ref):
    for name, got, want in zip(st.StreamingStats._fields, port, ref):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=name)
    assert port.count.dtype == port.hist.dtype == torch.int32


def _both(x, spec, include=None):
    port = st.stream_from_values(
        torch.from_numpy(x), spec,
        include=None if include is None else torch.from_numpy(include),
    )
    ref = ref_st.stream_from_values(
        jnp.asarray(x), spec, include=None if include is None else jnp.asarray(include)
    )
    return port, ref


def test_sketch_spec_matches_reference():
    for kw in ({}, {"lo": 0.5, "hi": 400.0, "bins": 64}, {"bins": 1}):
        got, want = st.SketchSpec(**kw), ref_st.SketchSpec(**kw)
        assert (got.growth, got.rel_error, got.n_buckets) == (
            want.growth, want.rel_error, want.n_buckets)
        assert got.edges.dtype == np.float64
        np.testing.assert_array_equal(got.edges, want.edges)
    assert st.DEFAULT_SKETCH == st.SketchSpec()
    for bad in ({"lo": 0.0}, {"lo": 5.0, "hi": 1.0}, {"bins": 0}):
        with pytest.raises(ValueError):
            st.SketchSpec(**bad)


@pytest.mark.parametrize("shape", [(), (3,), (3, 4)])
def test_stream_init_is_empty(shape):
    s = st.stream_init(st.DEFAULT_SKETCH, shape, device="cpu")
    _assert_same_stats(s, ref_st.stream_init(st.DEFAULT_SKETCH, shape))
    assert torch.isnan(st.stream_mean(s)).all() and torch.isnan(st.stream_var(s)).all()
    assert torch.isnan(st.stream_quantile(s, 0.5)).all()


@pytest.mark.parametrize("spec", SPECS, ids=["default", "narrow"])
@pytest.mark.parametrize("lead", [(), (5,), (3, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_from_values_matches_reference(lead, masked, spec):
    shape = lead + (700,)
    x = _values(len(lead), shape)
    inc = _include(len(lead), shape) if masked else None
    port, ref = _both(x, spec, inc)
    _assert_same_stats(port, ref)
    np.testing.assert_allclose(
        st.stream_var(port).numpy(), np.asarray(ref_st.stream_var(ref)), rtol=RTOL)
    np.testing.assert_allclose(
        st.stream_mean(port).numpy(), np.asarray(ref_st.stream_mean(ref)), rtol=RTOL)
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        np.testing.assert_allclose(
            st.stream_quantile(port, q, spec).numpy(),
            np.asarray(ref_st.stream_quantile(ref, q, spec)), rtol=RTOL)


def test_fold_carries_state_like_the_reference():
    """Three successive blocks folded into one accumulator, some values
    masked out, against the reference folding the same blocks."""
    spec = st.DEFAULT_SKETCH
    port = st.stream_init(spec, (4,), device="cpu")
    ref = ref_st.stream_init(spec, (4,))
    for i in range(3):
        x, inc = _values(10 + i, (4, 300)), _include(10 + i, (4, 300))
        port = st.stream_fold(port, torch.from_numpy(x), spec, include=torch.from_numpy(inc))
        ref = ref_st.stream_fold(ref, jnp.asarray(x), spec, include=jnp.asarray(inc))
        _assert_same_stats(port, ref)


def test_merge_matches_reference_and_an_empty_side_is_identity():
    spec = st.DEFAULT_SKETCH
    a_p, a_r = _both(_values(1, (3, 200)), spec)
    b_p, b_r = _both(_values(2, (3, 500)), spec, _include(2, (3, 500)))
    _assert_same_stats(st.stream_merge(a_p, b_p), ref_st.stream_merge(a_r, b_r))
    _assert_same_stats(st.stream_merge(b_p, a_p), ref_st.stream_merge(b_r, a_r))
    empty = st.stream_init(spec, (3,), device="cpu")
    for got in (st.stream_merge(empty, a_p), st.stream_merge(a_p, empty)):
        for x, y in zip(got, a_p):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_reduce_matches_reference(axis):
    spec = st.DEFAULT_SKETCH
    x = _values(7, (4, 5, 300))
    port, ref = _both(x, spec, _include(7, x.shape))
    _assert_same_stats(st.stream_reduce(port, axis), ref_st.stream_reduce(ref, axis))
    # the reduced count and histogram are those of one pass over the values
    ax = axis % 2
    inc = _include(7, x.shape)
    flat = lambda a: torch.from_numpy(np.moveaxis(a, ax, 1).reshape(x.shape[1 - ax], -1))
    whole = st.stream_from_values(flat(x), spec, include=flat(inc))
    red = st.stream_reduce(port, axis)
    assert torch.equal(red.count, whole.count)
    assert torch.equal(red.hist, whole.hist)


def test_windowed_quantile_mean_matches_reference_and_skips_empty_windows():
    spec = st.DEFAULT_SKETCH
    x = _values(3, (2, 6, 400))
    inc = _include(3, x.shape)
    inc[:, 2] = False  # an empty window per row
    port, ref = _both(x, spec, inc)
    for q in (0.5, 0.99):
        got = st.windowed_quantile_mean(port, q, spec)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref_st.windowed_quantile_mean(ref, q, spec)), rtol=RTOL)
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99])
def test_quantile_brackets_the_order_statistic(q):
    """x_(ceil(q n)) <= estimate <= growth * x_(ceil(q n)) for values in the
    regular range, with the rank taken in float32 as the sketch takes it."""
    spec = st.DEFAULT_SKETCH
    x = torch.from_numpy(np.exp(np.random.default_rng(5).normal(4.0, 1.0, 36_000))
                         .astype(np.float32))
    s = st.stream_from_values(x, spec)
    rank = int(torch.ceil(q * s.count.to(torch.float32)))
    exact = float(torch.kthvalue(x, rank).values)
    est = float(st.stream_quantile(s, q, spec))
    assert exact <= est <= spec.growth * exact


# --------------------------------------------------------------- simulator


@pytest.fixture(scope="module")
def quickstart_runs():
    """The quickstart plan at theta = 200, simulated by both packages on the
    reference's draws with a sketch."""
    ks = np.array([6.0, 7.0, 4.0], np.float32)
    lam = np.full(3, 0.125 / 3, np.float32)
    chunk = float(np.mean(200.0 / ks))
    ref_cl = ref_testbed()
    sol = ref_solve(RefProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                               moments=ref_cl.moments(chunk), cost=ref_cl.cost,
                               theta=200.0), max_iters=300)
    key, n = jax.random.key(5), 3000
    ref = ref_sim.simulate(key, sol.pi, jnp.asarray(lam), ref_cl, chunk, n,
                           sketch=st.DEFAULT_SKETCH)
    raw = _ref_draws(key, lam[None], n, 12)
    draws = _port_draws(raw)
    pi = np.array(sol.pi)
    port = simulate(None, torch.from_numpy(pi), torch.from_numpy(lam),
                    tahoe_testbed(device="cpu"), chunk, n, sketch=st.DEFAULT_SKETCH,
                    draws=draws)
    # Madow masks from the two cumsums: none flips at this seed
    masks = madow_sample(draws.u, torch.from_numpy(pi)[draws.file_id]).numpy()
    flips = int((masks != _ref_masks(pi, raw[2], np.asarray(raw[1]))).any(-1).sum())
    return port, ref, flips


def test_simulate_sketch_matches_reference_on_its_draws(quickstart_runs):
    port, ref, flips = quickstart_runs
    assert flips == 0
    np.testing.assert_array_equal(port.latency.numpy(), np.asarray(ref.latency))
    _assert_same_stats(port.stream, ref.stream)
    assert int(port.stream.count) == port.latency.shape[0] == 2700
    np.testing.assert_allclose(
        float(st.stream_mean(port.stream)), float(port.latency.mean()), rtol=1e-5)


def test_simulate_without_sketch_has_no_stream(quickstart_runs):
    port, _, _ = quickstart_runs
    cl = tahoe_testbed(device="cpu")
    run = simulate(torch.Generator().manual_seed(0), torch.full((3, 12), 0.5),
                   torch.full((3,), 0.04), cl, 20.0, 200)
    assert run.stream is None and port.stream is not None


def test_per_class_stats_match_reference(quickstart_runs):
    port, ref, _ = quickstart_runs
    class_of_file = np.array([0, 1, 0])  # k = 6 and 4 together, k = 7 alone
    for n_classes in (2, 3):  # class 2 never requested: NaN, count 0
        got = port.per_class_stats(class_of_file, n_classes)
        want = ref.per_class_stats(class_of_file, n_classes)
        np.testing.assert_array_equal(got.count, want.count)
        for name in ("mean", "p95", "p99"):
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6)
    assert got.count[2] == 0 and np.isnan(got.mean[2])
    direct = per_class_latency_stats(port.latency, port.file_id,
                                     torch.tensor(class_of_file), 2)
    np.testing.assert_array_equal(direct.p99, port.per_class_stats(class_of_file, 2).p99)


def test_per_class_stats_flatten_leading_axes():
    rng = np.random.default_rng(0)
    lat, fid = rng.random((3, 50)).astype(np.float32), rng.integers(0, 4, (3, 50))
    cls = np.array([1, 0, 1, 2])
    got = per_class_latency_stats(torch.from_numpy(lat), torch.from_numpy(fid), cls, 3)
    want = ref_sim.per_class_latency_stats(lat, fid, cls, 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("qs", [None, np.array([0.5, 0.9, 0.95, 0.99])])
def test_latency_cdf_matches_reference(quickstart_runs, qs):
    port, ref, _ = quickstart_runs
    q_got, v_got = simulate_latency_cdf(port, qs)
    q_want, v_want = ref_sim.simulate_latency_cdf(ref, qs)
    np.testing.assert_array_equal(q_got, q_want)
    np.testing.assert_allclose(v_got, v_want, rtol=1e-6)
