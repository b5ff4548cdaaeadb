"""The port's GF(256) arithmetic and GF(256) matmul layer against the reference.

On the CPU the port's ``ops`` runs the CUDA kernels' plain twins (the
K-scan of 8-round xtime multiplies) and never a kernel; ``chip_smoke.py``
holds kernels B2 and B3 to those twins on the card. Here the twins are
held to the reference's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them, and to its ``ref`` oracle. Inputs are
made with numpy from a seed and handed to both packages. GF(256)
arithmetic is exact, so every comparison is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ops_ref
import repro.storage.gf256 as ref_gf
from repro.kernels import gf256_matmul_pallas, gf256_matmul_pallas_batched
from repro.kernels import gf256_matmul_ref as ref_matmul
from repro.kernels import rs_decode as ref_rs_decode
from repro.kernels import rs_encode as ref_rs_encode
from repro_torch.kernels import (
    gf256_matmul,
    gf256_matmul_batch,
    gf256_matmul_batched_cuda,
    gf256_matmul_batched_plain,
    gf256_matmul_cuda,
    gf256_matmul_dense_ref,
    gf256_matmul_plain,
    gf256_matmul_ref,
    ops,
    rs_decode,
    rs_encode,
)
from repro_torch.storage import gf256
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# the sweep of tests/test_kernels.py
SHAPES = [
    (1, 1, 1),
    (3, 4, 5),
    (8, 8, 8),
    (16, 100, 64),
    (5, 7, 512),
    (128, 128, 128),
    (130, 120, 260),
    (256, 64, 300),
]
BATCHED = [(5, 6, 6, 200), (3, 4, 7, 129), (2, 12, 12, 4099)]
ALL = np.arange(256, dtype=np.uint8)


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- arithmetic


def test_uint8_shift_wraps_as_jnp_does():
    """xtime relies on ``a << 1`` dropping the carry out of bit 7."""
    got = _t(ALL) << 1
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(ALL) << 1))
    np.testing.assert_array_equal(got.numpy(), (ALL.astype(np.int32) << 1) & 0xFF)


def test_tables_and_bit_basis_equal_the_reference():
    for port, ref in zip(gf256._tables(), ref_gf._tables()):
        np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(gf256._bit_basis(), ref_gf._bit_basis())
    assert gf256.POLY == ref_gf.POLY


def test_table_multiply_equals_xtime_on_all_pairs():
    """All 256 x 256 products. A uint8 index tensor would be read as a
    boolean mask by torch; the table multiply must gather with ``long``."""
    a, b = np.meshgrid(ALL, ALL, indexing="ij")
    table = gf256.gf_mul_table(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(table, gf256.gf_mul_xtime(_t(a), _t(b)).numpy())
    np.testing.assert_array_equal(table, np.asarray(ref_gf.gf_mul_table(a, b)))
    np.testing.assert_array_equal(table, np.asarray(ref_gf.gf_mul_xtime(a, b)))


def test_inverse_matches_reference_and_inverts():
    inv = gf256.gf_inv(_t(ALL)).numpy()
    np.testing.assert_array_equal(inv, np.asarray(ref_gf.gf_inv(ALL)))
    prod = gf256.gf_mul(_t(ALL[1:]), _t(inv[1:])).numpy()
    assert (prod == 1).all() and inv[0] == 0


def test_bit_helpers_match_reference():
    x = _rand(0, 3, 37)
    bits = gf256.bytes_to_bits(_t(x))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_gf.bytes_to_bits(x)))
    np.testing.assert_array_equal(gf256.bits_to_bytes(bits).numpy(), x)
    np.testing.assert_array_equal(
        gf256.gf_const_to_bitmatrix(_t(x)).numpy(),
        np.asarray(ref_gf.gf_const_to_bitmatrix(x)),
    )


# ---------------------------------------------------------- matmul layer


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_twin_matches_pallas_kernel(m, k, n):
    a, b = _rand(m * 1000 + k, m, k), _rand(n, k, n)
    want = np.asarray(gf256_matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(gf256_matmul_plain(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(gf256_matmul_ref(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("bsz,m,k,n", BATCHED)
def test_batched_plain_twin_matches_pallas_kernel(bsz, m, k, n):
    a, b = _rand(bsz + m, bsz, m, k), _rand(n, bsz, k, n)
    want = np.asarray(
        gf256_matmul_pallas_batched(jnp.asarray(a), jnp.asarray(b), interpret=True)
    )
    np.testing.assert_array_equal(gf256_matmul_batched_plain(_t(a), _t(b)).numpy(), want)


def test_oracles_agree_with_reference_oracles():
    a, b = _rand(1, 20, 30), _rand(2, 30, 40)
    want = np.asarray(ref_matmul(a, b))
    np.testing.assert_array_equal(gf256_matmul_dense_ref(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(gf256.gf_matmul_ref(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("m,k,n", SHAPES[:6])
def test_bitplane_matches_ref(m, k, n):
    a, b = _t(_rand(m, m, k)), _t(_rand(n, k, n))
    np.testing.assert_array_equal(
        gf256_matmul(a, b, backend="bitplane").numpy(),
        gf256_matmul(a, b, backend="ref").numpy(),
    )


@pytest.mark.parametrize("bsz,m,k,n", BATCHED)
def test_batched_bitplane_matches_ref(bsz, m, k, n):
    a, b = _t(_rand(bsz, bsz, m, k)), _t(_rand(n, bsz, k, n))
    np.testing.assert_array_equal(
        gf256_matmul_batch(a, b, backend="bitplane").numpy(),
        gf256_matmul_batch(a, b, backend="ref").numpy(),
    )


@pytest.mark.parametrize("backend", ["pallas", "xla", "kernel"])
def test_unknown_backends_raise(backend):
    a, b = _t(_rand(0, 3, 4)), _t(_rand(1, 4, 5))
    with pytest.raises(ValueError):
        gf256_matmul(a, b, backend=backend)
    with pytest.raises(ValueError):
        gf256_matmul_batch(a[None], b[None], backend=backend)


def test_auto_on_cpu_runs_the_plain_twins_and_launches_nothing(monkeypatch):
    calls = []

    def spy(plain):
        def run(a, b):
            calls.append(plain.__name__)
            return plain(a, b)
        return run

    monkeypatch.setattr(ops, "gf256_matmul_plain", spy(gf256_matmul_plain))
    monkeypatch.setattr(ops, "gf256_matmul_batched_plain", spy(gf256_matmul_batched_plain))
    before = (gf256_matmul_cuda.launches, gf256_matmul_batched_cuda.launches)
    a, b = _rand(3, 4, 6), _rand(4, 6, 33)
    np.testing.assert_array_equal(
        gf256_matmul(_t(a), _t(b)).numpy(), np.asarray(ref_matmul(a, b))
    )
    gf256_matmul_batch(_t(a)[None], _t(b)[None])
    assert calls == ["gf256_matmul_plain", "gf256_matmul_batched_plain"]
    assert (gf256_matmul_cuda.launches, gf256_matmul_batched_cuda.launches) == before


def test_kernel_backend_refuses_cpu_tensors():
    """The kernels take CUDA tensors only: no silent fallback to a twin."""
    a, b = _t(_rand(0, 3, 4)), _t(_rand(1, 4, 5))
    with pytest.raises(ValueError):
        gf256_matmul(a, b, backend="cuda")
    with pytest.raises(ValueError):
        gf256_matmul_batch(a[None], b[None], backend="cuda")
    with pytest.raises(ValueError):
        gf256_matmul_cuda(a, b)


def test_shape_contract_is_checked():
    with pytest.raises(ValueError):
        gf256_matmul_plain(_t(_rand(0, 3, 4)), _t(_rand(1, 5, 5)))
    with pytest.raises(ValueError):
        gf256_matmul_batched_plain(_t(_rand(0, 2, 3, 3)), _t(_rand(1, 3, 3, 4)))
    with pytest.raises(ValueError):
        gf256_matmul_batch(_t(_rand(0, 3, 3)), _t(_rand(1, 3, 4)))


@pytest.mark.parametrize("backend", ["auto", "ref", "bitplane"])
def test_rs_paths_match_reference(backend):
    n, k = 9, 5
    data = _rand(7, k, 77)
    coded = rs_encode(_t(data), n, backend=backend).numpy()
    np.testing.assert_array_equal(coded, np.asarray(ref_rs_encode(data, n, backend="ref")))
    for ids in ([0, 1, 2, 3, 4], [4, 2, 0, 1, 3], [1, 3, 5, 7, 8], [4, 5, 6, 7, 8]):
        got = rs_decode(_t(coded[ids]), ids, n, k, backend=backend).numpy()
        want = np.asarray(ref_rs_decode(coded[ids], ids, n, k, backend="ref"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)


# ------------------------------------------- empty extents and views (C1, C2)

def gf256_matmul_batch_ref(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return np.asarray(ops_ref.gf256_matmul_batch(a, b, backend="ref"))


EMPTY = [(0, 4, 5), (3, 4, 0), (3, 0, 5), (0, 0, 0)]
EMPTY_BATCHED = [(2, 3, 0, 5), (0, 3, 4, 5), (2, 0, 4, 5), (2, 3, 4, 0)]


@pytest.mark.parametrize("backend", ["auto", "ref", "bitplane", "cuda"])
@pytest.mark.parametrize("m,k,n", EMPTY)
def test_empty_extents_match_reference_without_a_launch(m, k, n, backend):
    """M or N = 0 gives the empty result and K = 0 zeros, as the reference
    does. The dispatcher answers before any backend runs: even ``cuda``,
    whose launcher refuses CPU tensors and empty operands, is not reached."""
    a, b = _rand(m, m, k), _rand(n, k, n)
    got = gf256_matmul(_t(a), _t(b), backend=backend)
    want = np.asarray(ops_ref.gf256_matmul(a, b, backend="ref"))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape == (m, n)


@pytest.mark.parametrize("backend", ["auto", "ref", "bitplane", "cuda"])
@pytest.mark.parametrize("bsz,m,k,n", EMPTY_BATCHED)
def test_empty_batched_extents_match_reference(bsz, m, k, n, backend):
    a, b = _rand(m, bsz, m, k), _rand(n, bsz, k, n)
    got = gf256_matmul_batch(_t(a), _t(b), backend=backend)
    want = np.asarray(ops_ref.gf256_matmul_batch(a, b, backend="ref"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_extents_still_check_shapes():
    with pytest.raises(ValueError):
        gf256_matmul(_t(_rand(0, 0, 4)), _t(_rand(1, 3, 5)))
    with pytest.raises(ValueError):
        gf256_matmul_batch(_t(_rand(0, 2, 3, 0)), _t(_rand(1, 3, 0, 5)))


def test_launchers_stay_strict_on_empty_operands():
    with pytest.raises(ValueError):
        gf256_matmul_cuda(_t(_rand(0, 0, 4)), _t(_rand(1, 4, 5)))


def test_views_reach_the_kernel_contiguous(monkeypatch):
    """The ``cuda`` dispatch hands the launchers contiguous operands, so a
    sliced view works as it does in the reference (the launchers raise on
    anything else). A spy stands in for the launchers on the CPU."""
    seen = []

    def spy(plain):
        def run(a, b):
            seen.append(a.is_contiguous() and b.is_contiguous())
            return plain(a, b)
        return run

    monkeypatch.setattr(ops, "gf256_matmul_cuda", spy(gf256_matmul_plain))
    monkeypatch.setattr(ops, "gf256_matmul_batched_cuda", spy(gf256_matmul_batched_plain))
    a, b = _rand(5, 6, 8), _rand(6, 8, 40)
    a_view, b_view = _t(a).T.contiguous().T, _t(b)[:, ::2]
    assert not a_view.is_contiguous() and not b_view.is_contiguous()
    got = gf256_matmul(a_view, b_view, backend="cuda")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_matmul(a, b[:, ::2])))
    a3, b3 = _t(b)[None, :, 1:7].transpose(1, 2)[:, :, :6], _t(b)[None, :6, ::3]
    assert not a3.is_contiguous() and not b3.is_contiguous()
    got = gf256_matmul_batch(a3, b3, backend="cuda")
    want = gf256_matmul_batch_ref(b[None, :, 1:7].transpose(0, 2, 1)[:, :, :6],
                                  b[None, :6, ::3])
    np.testing.assert_array_equal(got.numpy(), want)
    assert seen == [True, True]
