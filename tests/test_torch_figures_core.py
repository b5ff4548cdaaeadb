"""The port's §V figure helpers against the reference, on the CPU.

* ``split_merge_bound`` and ``fork_join_exact_nn`` over grids of n, k, mu
  and lam that include unstable points: the same +inf pattern, finite
  values within rtol 1e-6. The harmonic tables are the reference's own,
  bit for bit (summed in its cumsum's order).
* ``fit_shifted_exponential``, ``ServiceMoments.validate``: rtol 1e-5 and
  the same errors.
* ``decompose_subsets`` and ``check_feasible``: host numpy in both
  packages, so the same subsets, weights (atol 1e-9) and booleans.
* ``homogeneous_cluster``, ``measured_fig6_moments``, ``Cluster.subset``
  and ``Cluster.perturbed``: parameters and moments within rtol 1e-6.
"""
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.baselines as ref_base
import repro.core.projection as ref_proj
import repro.core.queueing as ref_q
import repro.core.scheduling as ref_sched
import repro.storage.cluster as ref_cluster
import repro_torch.core.baselines as base
import repro_torch.core.queueing as q
import repro_torch.core.scheduling as sched
import repro_torch.storage.cluster as cluster
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

M = 12
MU = 1.0 / 13.9  # the paper's measured service rate (Fig. 6)


def _same_with_infs(port, ref, rtol):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol)


# (n, k) pairs of the paper's codes and beyond, at loads on both sides of
# the split-merge queue's stability edge lam * E[S] = 1
NK = [(n, k) for n in (1, 2, 4, 7, 12, 40) for k in (1, 2, 4, 7, 12) if k <= n]


@pytest.mark.parametrize("mu", [MU, 0.5, 3.0])
def test_split_merge_bound_matches_reference_on_a_grid(mu):
    n, k = (np.array(x) for x in zip(*NK))
    lam = np.array([1 / 60, 1 / 14, 1 / 9, 0.3, 2.0, 10.0], np.float32)
    nn, kk, ll = (x.ravel() for x in np.meshgrid(n, k, lam, indexing="ij")[:3])
    ok = kk <= nn
    nn, kk, ll = nn[ok], kk[ok], ll[ok]
    got = base.split_merge_bound(torch.tensor(nn), torch.tensor(kk), mu, torch.tensor(ll))
    want = ref_base.split_merge_bound(nn, kk, mu, ll)
    assert got.dtype == torch.float32
    assert np.isinf(want).any() and np.isfinite(want).any()
    _same_with_infs(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("n,k", [(7, 4), (12, 6), (4, 4), (3, 1)])
def test_split_merge_bound_scalars_match_and_diverge(n, k):
    """Fig. 7's call: Python n, k, mu and a scalar lam; +inf past the edge."""
    for inv_lam in (60, 40, 24, 14, 12, 10, 9, 2):
        got = base.split_merge_bound(n, k, MU, 1.0 / inv_lam)
        want = ref_base.split_merge_bound(n, k, MU, 1.0 / inv_lam)
        assert got.shape == ()
        _same_with_infs(got.numpy(), want, rtol=1e-6)
    assert torch.isinf(base.split_merge_bound(n, k, MU, 10.0))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 256, 4096])
def test_scan_cumsum_is_the_reference_cumsum_bit_for_bit(n):
    x = np.random.default_rng(n).random(n).astype(np.float32) / np.arange(1, n + 1)
    got = base._scan_cumsum(torch.from_numpy(x.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_harmonic_range_matches_reference():
    lo = np.array([0, 0, 3, 7, 100, 4000])
    hi = np.array([1, 7, 7, 12, 4000, 4096])
    for order in (1, 2):
        got = base._harmonic_range(torch.tensor(lo), torch.tensor(hi), order)
        want = ref_base._harmonic_range(jnp.asarray(lo), jnp.asarray(hi), order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("mu", [MU, 1.0])
def test_fork_join_exact_nn_matches_reference(mu):
    n = np.array([1, 2, 4, 7, 12, 40, 63])
    for lam in (0.01, 0.5 * mu, 0.99 * mu, mu, 2.0 * mu):
        got = base.fork_join_exact_nn(torch.tensor(n), mu, lam)
        want = ref_base.fork_join_exact_nn(n, mu, lam)
        _same_with_infs(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------- queueing


@pytest.mark.parametrize("chunk_mb", [12.5, 25.0, 150.0 / 7])
def test_fit_shifted_exponential_round_trips_the_cluster(chunk_mb):
    cl, ref_cl = cluster.tahoe_testbed(device="cpu"), ref_cluster.tahoe_testbed()
    mom, ref_mom = cl.moments(chunk_mb), ref_cl.moments(chunk_mb)
    d, rate = q.fit_shifted_exponential(mom.mean, mom.m2)
    d_ref, rate_ref = ref_q.fit_shifted_exponential(ref_mom.mean, ref_mom.m2)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5)
    np.testing.assert_allclose(rate.numpy(), np.asarray(rate_ref), rtol=1e-5)
    # the inverse of Cluster.moments: the cluster's own (D_j, bw_j / B)
    d_true, rate_true = cl.service_params(chunk_mb)
    np.testing.assert_allclose(d.numpy(), d_true.numpy(), rtol=1e-3)
    np.testing.assert_allclose(rate.numpy(), rate_true.numpy(), rtol=1e-3)


def test_fit_shifted_exponential_clamps_like_the_reference():
    """A mean below one standard deviation clamps D to 0; a zero variance is
    floored at 1e-9."""
    m1 = np.array([1.0, 2.0, 3.0], np.float32)
    m2 = np.array([5.0, 4.0, 9.5], np.float32)  # var 4, 0, 0.5
    got = q.fit_shifted_exponential(torch.tensor(m1), torch.tensor(m2))
    want = ref_q.fit_shifted_exponential(jnp.asarray(m1), jnp.asarray(m2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    assert float(got[0][0]) == 0.0 and float(got[1][1]) == pytest.approx(1 / 1e-9**0.5, rel=1e-5)


BAD_MOMENTS = {
    "valid": ([0.1, 0.2], [150.0, 40.0], [4000.0, 500.0]),
    "m2 below mean^2": ([0.1, 0.2], [99.0, 40.0], [4000.0, 500.0]),
    "Lyapunov": ([0.1, 0.2], [150.0, 40.0], [1000.0, 500.0]),
}


@pytest.mark.parametrize("case", BAD_MOMENTS)
def test_validate_raises_where_the_reference_does(case):
    mu, m2, m3 = (np.array(x, np.float32) for x in BAD_MOMENTS[case])
    port = q.ServiceMoments(*(torch.tensor(x) for x in (mu, m2, m3)))
    ref = ref_q.ServiceMoments(*(jnp.asarray(x) for x in (mu, m2, m3)))
    try:
        ref.validate()
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port.validate()
    else:
        assert case == "valid"
        port.validate()


# -------------------------------------------------------------- scheduling


def _feasible_pi(seed, r, m=M, ks=(1, 2, 4, 6, 7)):
    """Random feasible pi: random scores projected (by the reference) onto
    the capped simplex of random k's; includes k == 1 rows."""
    rng = np.random.default_rng(seed)
    k = rng.choice(ks, size=r).astype(np.float32)
    k[0] = 1.0
    v = rng.random((r, m)).astype(np.float32)
    pi = np.array(ref_proj.project_capped_simplex(jnp.asarray(v), jnp.asarray(k)))
    return pi, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_subsets_matches_reference(seed):
    pi, _ = _feasible_pi(seed, 6)
    for row in pi:
        got = sched.decompose_subsets(torch.from_numpy(row))
        want = ref_sched.decompose_subsets(row)
        assert len(got) == len(want)
        for (a, s), (a_ref, s_ref) in zip(got, want):
            np.testing.assert_allclose(a, a_ref, atol=1e-9)
            np.testing.assert_array_equal(s, s_ref)
        # the decomposition reproduces the marginals
        recon = sum(a * s for a, s in got)
        np.testing.assert_allclose(recon, row, atol=1e-5)


def test_decompose_subsets_errors_match_reference():
    for bad in (np.array([1.5, 0.5]), np.array([0.5, 0.7])):
        with pytest.raises(ValueError) as e_ref:
            ref_sched.decompose_subsets(bad)
        with pytest.raises(ValueError, match=re.escape(str(e_ref.value))):
            sched.decompose_subsets(torch.tensor(bad))
    assert sched.decompose_subsets(np.zeros(4)) == ref_sched.decompose_subsets(np.zeros(4)) == []


@pytest.mark.parametrize("seed", [0, 3])
def test_check_feasible_matches_reference(seed):
    pi, k = _feasible_pi(seed, 20)
    mask = pi > 1e-4
    cases = {
        "feasible": (pi, k, None),
        "masked": (pi, k, mask),
        "outside mask": (pi, k, np.roll(mask, 1, axis=-1)),
        "box": (pi * 1.5, k * 1.5, None),
        "sum": (pi, k + 1.0, None),
        "negative": (pi - 0.01, k - 0.01 * M, None),
    }
    got = {
        name: sched.check_feasible(
            torch.from_numpy(p), torch.from_numpy(kk),
            None if mk is None else torch.from_numpy(mk))
        for name, (p, kk, mk) in cases.items()
    }
    want = {name: ref_sched.check_feasible(*args) for name, args in cases.items()}
    assert got == want
    assert got["feasible"] and got["masked"] and not got["box"] and not got["sum"]


# ----------------------------------------------------------------- cluster


def _assert_same_cluster(port, ref, chunk_mb=12.5):
    assert port.m == ref.m
    assert [nd.name for nd in port.nodes] == [nd.name for nd in ref.nodes]
    for get in (lambda c: c.cost, lambda c: c.overheads(), lambda c: c.bandwidths()):
        np.testing.assert_allclose(get(port).numpy(), np.asarray(get(ref)), rtol=1e-6)
    for a, b in zip(port.moments(chunk_mb), ref.moments(chunk_mb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"overhead_s": 5.0, "bandwidth_mbps": 2.0, "cost": 0.7},
                                {"chunk_mb": 25.0, "sigma_s": 3.0}])
@pytest.mark.parametrize("m", [1, 7, 12])
def test_homogeneous_cluster_matches_reference(m, kw):
    port = cluster.homogeneous_cluster(m, device="cpu", **kw)
    _assert_same_cluster(port, ref_cluster.homogeneous_cluster(m, **kw))
    assert port.device == torch.device("cpu")


def test_homogeneous_cluster_has_the_paper_fig6_moments():
    mom = cluster.homogeneous_cluster(7, device="cpu").moments(12.5)
    np.testing.assert_allclose(mom.mean.numpy(), 13.9, rtol=1e-6)
    np.testing.assert_allclose(mom.var.numpy(), 4.3**2, rtol=1e-4)


def test_measured_fig6_moments_match_and_validate():
    got = cluster.measured_fig6_moments(device="cpu")
    want = ref_cluster.measured_fig6_moments()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (1,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    got.validate()


def test_figure_helpers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.homogeneous_cluster(7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster.measured_fig6_moments()


@pytest.mark.parametrize("keep", [[0, 1, 2, 3], [11, 0, 5], list(range(1, 12))])
def test_subset_matches_reference_and_keeps_the_device(keep):
    port = cluster.tahoe_testbed(device="cpu").subset(keep)
    _assert_same_cluster(port, ref_cluster.tahoe_testbed().subset(keep))
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("ovh,bw", [(1.0, 1.0), (1.5, 0.7),
                                    (list(np.linspace(0.5, 2.0, M)), 0.9),
                                    (1.0, list(np.linspace(1.2, 0.3, M)))])
def test_perturbed_matches_reference_and_keeps_the_device(ovh, bw):
    port = cluster.tahoe_testbed(device="cpu").perturbed(ovh, bw)
    ref = ref_cluster.tahoe_testbed().perturbed(ovh, bw)
    for chunk in (12.5, 37.5):
        _assert_same_cluster(port, ref, chunk)
    assert port.device == torch.device("cpu")
    assert [nd.site for nd in port.nodes] == [nd.site for nd in ref.nodes]


def test_perturbed_drifts_sampler_and_moments_together():
    cl = cluster.homogeneous_cluster(3, device="cpu").perturbed(2.0, 0.5)
    mom = cl.moments(12.5)
    s = cl.sample_service(torch.Generator().manual_seed(0), 12.5, (200_000,))
    np.testing.assert_allclose(s.mean(0).numpy(), mom.mean.numpy(), rtol=0.01)
    assert list(itertools.chain(*[[nd.overhead_s] for nd in cl.nodes])) == [19.2] * 3
