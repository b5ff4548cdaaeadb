"""The port's batched JLCM solver and the Fig. 9 baselines against the
reference, on the CPU.

``solve_batch`` on Fig. 13's three-file problem at all eight theta
(``max_iters=400``, default eps, as ``benchmarks/fig13_tradeoff.py``) and
on the §V.B catalog cut to r = 64 at two file sizes and two rate scales
(the figures' ``max_iters=400`` and default eps), against the reference's
``solve_batch``:

* identical ``n`` and ``placement``; pi within atol 1e-3; ``objective`` and
  ``latency_tight`` within rtol 1e-3 (the tolerances
  ``tests/test_torch_slice.py`` documents: float32 sums in another order,
  amplified by the backtracking line search);
* per-instance ``iterations``: identical, or both runs stopped in the flat
  valley of ``ROADMAP.md`` §C: the run that goes on moves its objective by
  less than 10 x eps (relative) in all after the other stopped. Measured:
  Fig. 13 stops at 306, 310, 350, 281, 267 and 400 x 3 iterations in the
  reference; the port takes 311 at theta = 1 and 268 at theta = 10, and
  29 where the reference takes 26 on the catalog's 200 MB problem at the
  paper's rates;
* the trace is NaN-padded past each instance's end.

Each instance of the port's batch equals the port's own ``solve`` on that
problem (same steps, so the same iterations), also when it stops while the
rest of its batch runs on. ``proportional_lb_pi`` is held within rtol
1e-5, ``random_placement_mask`` bit for bit on uniforms whose argsort is
the reference's permutation, and ``max_ec_solution`` on its cost, n and
latency (rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from benchmarks.common import paper_catalog
from repro.storage import tahoe_testbed as ref_testbed
from repro_torch.core import (
    JLCMProblem,
    max_ec_solution,
    proportional_lb_pi,
    random_placement_mask,
    solve,
    solve_batch,
    stack_problems,
)
from repro_torch.core.jlcm import max_ec_problem, max_ec_report
from repro_torch.storage import tahoe_testbed
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
EPS = 1e-5
THETAS = (0.5, 1.0, 2.0, 10.0, 50.0, 100.0, 150.0, 200.0)
CATALOG = [(150.0, 1.0), (150.0, 1000 / 64), (200.0, 1.0), (200.0, 1000 / 64)]


def _pair(lam, ks, chunk_mb, theta):
    """The same problem for both packages (float32 numpy inputs)."""
    ref_cl, cl = ref_testbed(), tahoe_testbed(device="cpu")
    ref = ref_core.JLCMProblem(lam=jnp.asarray(lam), k=jnp.asarray(ks),
                               moments=ref_cl.moments(chunk_mb), cost=ref_cl.cost,
                               theta=theta)
    port = JLCMProblem(lam=torch.tensor(lam), k=torch.tensor(ks),
                       moments=cl.moments(chunk_mb), cost=cl.cost, theta=theta)
    return ref, port


def _fig13():
    ks = np.array([6.0, 7.0, 4.0], np.float32)
    lam = np.full(3, 0.125 / 3, np.float32)
    return [_pair(lam, ks, float(np.mean(200.0 / ks)), t) for t in THETAS]


def _catalog(file_mb, scale, r=64):
    """fig11/fig12's problem on the catalog cut to r files: the chunk sizes
    of ``file_mb``, the paper's rates times ``scale``, theta = 2."""
    lam, ks, chunk = paper_catalog(r=r, file_mb=file_mb)
    lam = np.asarray(lam)  # float32, as the reference holds it
    eff = float(np.average(chunk, weights=lam))
    return _pair(lam * np.float32(scale), np.asarray(ks), eff, 2.0)


@pytest.fixture(scope="module", params=["fig13", "catalog"])
def batches(request):
    pairs = _fig13() if request.param == "fig13" else [_catalog(*c) for c in CATALOG]
    refs, ports = zip(*pairs)
    ref = ref_core.solve_batch(list(refs), max_iters=400)
    port = solve_batch(list(ports), max_iters=400)
    return request.param, ports, ref, port


def _row(sol, i):
    return type(sol)(*(None if f is None else f[i] for f in sol))


def _assert_same_plan(port, ref):
    np.testing.assert_array_equal(port.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(port.placement.numpy(), np.asarray(ref.placement))
    np.testing.assert_allclose(port.pi.numpy(), np.asarray(ref.pi), atol=1e-3)
    for name in ("objective", "latency_tight", "latency"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-3)
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)


def _stopped_in_the_same_valley(trace_a, trace_b):
    """Iterations differ only past a flat valley: the longer run's objective
    after the shorter run's stop moves by < 10 eps (relative) in all."""
    a, b = trace_a[np.isfinite(trace_a)], trace_b[np.isfinite(trace_b)]
    short, long_ = (a, b) if a.size <= b.size else (b, a)
    tail = long_[short.size - 1:]
    return abs(tail[-1] - tail[0]) < 10 * EPS * max(abs(tail[-1]), 1.0)


def test_solve_batch_matches_the_reference_batch(batches):
    name, _, ref, port = batches
    assert port.pi.shape == np.asarray(ref.pi).shape
    _assert_same_plan(port, ref)
    it_ref, it = np.asarray(ref.iterations), port.iterations.numpy()
    for i in np.nonzero(it != it_ref)[0]:
        assert _stopped_in_the_same_valley(
            port.objective_trace[i].numpy(), np.asarray(ref.objective_trace[i])
        ), f"{name} instance {i}: {it[i]} iterations vs the reference's {it_ref[i]}"
    assert (it == it_ref).sum() >= len(it) - 2


def test_solve_batch_trace_is_nan_padded_past_each_end(batches):
    _, _, ref, port = batches
    tr = port.objective_trace.numpy()
    assert tr.shape == (len(port.iterations), 401) == np.asarray(ref.objective_trace).shape
    for i, n in enumerate(port.iterations.numpy()):
        assert np.isfinite(tr[i, : n + 1]).all() and np.isnan(tr[i, n + 1:]).all()
        assert (np.diff(tr[i, : n + 1]) <= 0).all()  # backtracking never accepts a rise
    assert port.iterations.dtype == torch.int64


def test_solve_batch_instances_equal_single_solves(batches):
    name, probs, _, port = batches
    # the instances that stop early, frozen while the rest of their batch
    # runs on to 400 iterations (a 400-iteration solve takes ~12 s here)
    picks = [0] if name == "fig13" else [0, 2]
    for i in picks:
        one = solve(probs[i], max_iters=400)
        row = _row(port, i)
        _assert_same_plan(row, one)
        assert int(row.iterations) == int(one.iterations)
        n = int(one.iterations)
        np.testing.assert_allclose(
            row.objective_trace[: n + 1].numpy(), one.objective_trace.numpy(), rtol=1e-5)


def test_solve_batch_takes_a_stacked_problem_and_shared_start():
    _, port = _catalog(150.0, 1.0, r=16)
    probs = [port._replace(theta=t) for t in (1.0, 4.0)]
    stacked = stack_problems(probs)
    assert stacked.mask.shape == (2, 16, M) and stacked.mask.all()
    assert stacked.theta.shape == (2,) and stacked.theta.dtype == torch.float32
    a = solve_batch(probs, max_iters=60)
    b = solve_batch(stacked, max_iters=60)
    for x, y in zip(a, b):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    start = torch.full((16, M), 0.5)
    c = solve_batch(probs, max_iters=60, pi0=start)
    assert c.pi.shape == (2, 16, M)
    with pytest.raises(ValueError, match="explicit mask"):
        solve_batch(stacked._replace(mask=None))
    with pytest.raises(ValueError, match="matches neither"):
        solve_batch(probs, pi0=torch.zeros((3, 16, M)))


def test_stack_problems_errors_match_reference():
    (r_a, p_a), (r_b, p_b) = _catalog(150.0, 1.0, r=8), _catalog(150.0, 1.0, r=12)
    with pytest.raises(ValueError, match="share \\(r, m\\)"):
        ref_core.stack_problems([r_a, r_b])
    with pytest.raises(ValueError, match="share \\(r, m\\)"):
        stack_problems([p_a, p_b])
    with pytest.raises(ValueError, match="at least one"):
        stack_problems([])
    # a batch mixing None with a value in an optional field, or its shapes
    for field, value in (("cost_weight", np.ones(8, np.float32)),
                         ("background", np.zeros(M, np.float32))):
        with pytest.raises(ValueError, match=field):
            ref_core.stack_problems([r_a, r_a._replace(**{field: jnp.asarray(value)})])
        with pytest.raises(ValueError, match=field):
            stack_problems([p_a, p_a._replace(**{field: torch.from_numpy(value)})])
        with pytest.raises(ValueError, match=field):
            stack_problems([p_a._replace(**{field: torch.from_numpy(value[:-1])}),
                            p_a._replace(**{field: torch.from_numpy(value)})])


# --------------------------------------------------------------- baselines


def _jlcm_placement():
    """JLCM's placement on the r = 64 catalog (the reference's plan)."""
    ref, port = _catalog(150.0, 1.0)
    sol = ref_core.solve(ref, max_iters=400)
    return ref, port, np.array(sol.placement), np.array(sol.n)


def test_proportional_lb_pi_matches_reference_batched_and_unbatched():
    ref, port, placement, n = _jlcm_placement()
    want = np.asarray(ref_core.proportional_lb_pi(placement, ref.k, ref.moments))
    got = proportional_lb_pi(torch.from_numpy(placement), port.k, port.moments)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # Random CP's shape: many candidate placements in one call
    masks = np.stack([placement, np.roll(placement, 1, -1), np.roll(placement, 5, -1)])
    batched = proportional_lb_pi(torch.from_numpy(masks), port.k, port.moments)
    assert batched.shape == masks.shape
    for i, mk in enumerate(masks):
        one = np.asarray(ref_core.proportional_lb_pi(mk, ref.k, ref.moments))
        np.testing.assert_allclose(batched[i].numpy(), one, rtol=1e-5, atol=1e-7)
        assert (batched[i].numpy()[~mk] == 0).all()


def _ref_uniforms(key, r, m):
    """Uniforms whose per-row argsort is the reference's permutation for
    ``key`` (``random_placement_mask`` splits it into one key a file)."""
    perm = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, m))(
        jax.random.split(key, r)))
    u = np.empty((r, m), np.float32)
    np.put_along_axis(u, perm, (np.arange(m, dtype=np.float32) + 0.5) / m, axis=-1)
    return u


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_placement_mask_on_the_reference_permutation(seed):
    r = 64
    n = np.random.default_rng(seed).integers(1, M + 1, r)
    key = jax.random.key(seed)
    want = np.asarray(ref_core.random_placement_mask(key, r, M, jnp.asarray(n)))
    got = random_placement_mask(torch.from_numpy(_ref_uniforms(key, r, M)), torch.from_numpy(n))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(-1).numpy(), n)


def test_random_placement_mask_is_batched_and_uniform():
    u = torch.rand((4000, 3, M), generator=torch.Generator().manual_seed(0))
    mask = random_placement_mask(u, torch.tensor([1, 4, 12]))
    assert mask.shape == (4000, 3, M)
    np.testing.assert_array_equal(mask.sum(-1).numpy(), np.tile([1, 4, 12], (4000, 1)))
    freq = mask.float().mean(0).numpy()
    np.testing.assert_allclose(freq[1], 4 / M, atol=0.03)
    np.testing.assert_allclose(freq[0], 1 / M, atol=0.02)


def test_max_ec_solution_matches_reference():
    ref, port = _catalog(150.0, 1.0)
    want = ref_core.max_ec_solution(ref, max_iters=400)
    got = max_ec_solution(port, max_iters=400)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    assert got.placement.all()
    np.testing.assert_allclose(float(got.latency), float(want.latency), rtol=1e-3)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-3)
    # as one instance of a batch, the same report
    sols = solve_batch([max_ec_problem(port), port], max_iters=400)
    row = max_ec_report(port, _row(sols, 0))
    np.testing.assert_allclose(float(row.latency), float(got.latency), rtol=1e-5)
    assert float(row.cost) == float(got.cost)
    assert torch.equal(row.n, got.n)
