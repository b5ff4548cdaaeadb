"""The frozen reference against the port's plain twins at tiny sizes."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from perfbench.reference import checks, fcfs, gf256
from repro_torch.core.scheduling import madow_sample
from repro_torch.kernels.fcfs_queue import fcfs_scan_plain
from repro_torch.storage import rs
from repro_torch.storage.gf256 import gf_matmul_ref, gf_mul_table

CODES = [(12, 6), (12, 7), (12, 4), (9, 6)]


def test_product_table_is_the_ports_field():
    a = torch.arange(256, dtype=torch.uint8)
    want = gf_mul_table(a[:, None], a[None, :]).numpy()
    assert np.array_equal(gf256.product_table(), want)


@pytest.mark.parametrize("n,k", CODES)
def test_generator_and_encode_match_the_port(n, k):
    assert np.array_equal(gf256.cauchy(n, k), rs.cauchy_parity_matrix(n, k))
    data = torch.randint(0, 256, (k, 301), generator=torch.Generator().manual_seed(n * k),
                         dtype=torch.uint8)
    assert torch.equal(gf256.encode(data, n), rs.encode(data, n, matmul=gf_matmul_ref))


@pytest.mark.parametrize("n,k", CODES)
def test_decode_matches_the_port_on_every_tenth_pattern(n, k):
    g = torch.Generator().manual_seed(7 * n + k)
    data = torch.randint(0, 256, (k, 97), generator=g, dtype=torch.uint8)
    coded = gf256.encode(data, n)
    for ids in list(itertools.combinations(range(1, n), k))[::10]:
        chunks = coded[list(ids)]
        got = gf256.decode(chunks, ids, n, k)
        assert torch.equal(got, data)
        assert torch.equal(got, rs.decode(chunks, ids, n, k, matmul=gf_matmul_ref))
        assert np.array_equal(gf256.invert(gf256.generator(n, k)[list(ids)]),
                              rs.gf_invert_matrix(rs.generator_matrix(n, k)[list(ids)]))


def test_xor_parity_control_is_another_code():
    data = torch.randint(0, 256, (6, 64), generator=torch.Generator().manual_seed(1),
                         dtype=torch.uint8)
    assert not torch.equal(gf256.xor_parity(data, 9), gf256.encode(data, 9))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_is_the_plain_twin_bitwise(seed):
    g = torch.Generator().manual_seed(seed)
    r, n, m = 3, 400, 12
    t = torch.cumsum(torch.empty((r, n)).exponential_(generator=g), -1)
    masks = torch.rand((r, n, m), generator=g) < 0.5
    masks[:, 5] = False  # a request with no node
    service = 0.2 + 1.5 * torch.empty((r, n, m)).exponential_(generator=g)
    zero = torch.zeros((r, m))
    want, _, _ = fcfs_scan_plain(t, masks, service, zero, zero)
    got = fcfs.walk(t.numpy(), masks.numpy(), service.numpy())
    assert torch.equal(got, want)
    assert not torch.equal(fcfs.walk(t.numpy(), masks.numpy(), service.numpy(),
                                     dtype=torch.bfloat16).float(), want)


def test_madow_is_the_ports_away_from_boundaries():
    rng = np.random.default_rng(3)
    k = np.array([6, 7, 6, 4] * 5)
    raw = rng.random((20, 12)) + 0.05
    pi = np.minimum(raw / raw.sum(1, keepdims=True) * k[:, None], 1.0).astype(np.float32)
    pi = (pi * (k / pi.sum(1))[:, None]).astype(np.float32)
    files = rng.integers(0, 20, 5000)
    u = rng.random(5000).astype(np.float32)
    keep = ~fcfs.near_boundary(u, pi[files])
    got = fcfs.madow(u, pi[files])
    want = madow_sample(torch.as_tensor(u), torch.as_tensor(pi)[files]).numpy()
    assert keep.mean() > 0.99
    assert np.array_equal(got[keep], want[keep])


def test_service_times_match_the_ports_cluster():
    from repro_torch.storage.cluster import tahoe_testbed

    c = tahoe_testbed(device="cpu")
    d, rate = c.service_params(21.5)
    exp = np.random.default_rng(0).exponential(size=(50, 12)).astype(np.float32)
    want = (d + torch.as_tensor(exp) / rate).numpy()
    got = fcfs.service_times(exp, [n.overhead_s for n in c.nodes],
                             [n.bandwidth_mbps for n in c.nodes], 21.5)
    assert np.array_equal(got, want)


def test_read_set_and_plan_checks():
    has = np.ones((3, 5), bool)
    has[2, 4] = False
    alive = np.array([False, True, True, True, True])
    sets = np.array([[0, 1, 1, 0, 0], [1, 1, 0, 0, 0], [0, 0, 1, 1, 1]], bool)
    assert checks.bad_read_sets(sets, np.array([2, 2, 3]), has, alive) == 2
    pi = np.array([[0.5, 0.5, 1.0, 0.0], [0.9, 0.9, 0.2, 0.0]])
    placement = pi > 1e-3
    assert checks.plan_violations(pi, np.array([2, 2]), placement.sum(1), placement) == 0
    mask = np.array([[True, True, True, False], [True, True, False, True]])
    assert checks.plan_violations(pi, np.array([2, 2]), placement.sum(1), placement, mask) == 1
    assert checks.plan_violations(pi, np.array([2, 3]), placement.sum(1), placement) == 1
