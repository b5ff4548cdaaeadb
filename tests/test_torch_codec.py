"""The port's Reed-Solomon codec, batched data plane and repair inventory
against the reference, bitwise, on the CPU.

Payloads are made with numpy from a seed and handed to both packages. On
the CPU the port's codec runs the GF(256) kernels' plain twins (the
``auto`` backend on CPU tensors); ``chip_smoke.py`` phase 5 runs the same
path on the card through kernels B2 and B3. The slice test takes the
port's own r = 64 catalog plan (whose n_i and placement
``tests/test_torch_slice.py`` holds equal to the reference's) through
encode, the failure of node 0 and ``decode_requests``, and holds every
byte to the reference's codec on the same plan and data.
"""
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.storage.codec as ref_codec
import repro.storage.repair as ref_repair
import repro.storage.rs as ref_rs
from benchmarks.common import paper_catalog
from repro_torch.core import JLCMProblem, solve
from repro_torch.storage import (
    CodecPlan,
    augment_plan,
    build_repair_flow,
    codec,
    decode_batch,
    encode_batch,
    host_loop_decode,
    lost_chunk_inventory,
    repair_schedule,
    rs,
    tahoe_testbed,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BACKENDS = ("auto", "ref", "bitplane")
NK = [(5, 4), (7, 4), (9, 6), (12, 7), (14, 10)]


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ref_encode(data, n):
    return np.asarray(ref_rs.encode(jnp.asarray(data), n))


# --------------------------------------------------------------- rs.py


@pytest.mark.parametrize("n,k", NK)
def test_host_matrices_match_reference(n, k):
    np.testing.assert_array_equal(rs.cauchy_parity_matrix(n, k), ref_rs.cauchy_parity_matrix(n, k))
    np.testing.assert_array_equal(rs.generator_matrix(n, k), ref_rs.generator_matrix(n, k))
    ids = tuple(range(n - k, n))  # the last k rows: parity-heavy
    np.testing.assert_array_equal(rs.decode_matrix(n, k, ids), ref_rs.decode_matrix(n, k, ids))
    g = rs.generator_matrix(n, k)[list(ids)]
    np.testing.assert_array_equal(rs.gf_invert_matrix(g), ref_rs.gf_invert_matrix(g))


def test_bad_inputs_raise_as_in_reference():
    with pytest.raises(ValueError):
        rs.cauchy_parity_matrix(4, 5)
    with pytest.raises(ValueError):
        rs.decode_matrix(7, 4, (0, 1, 2))
    with pytest.raises(ValueError):
        rs.decode_matrix(7, 4, (0, 1, 2, 2))
    with pytest.raises(ZeroDivisionError):
        rs.gf_invert_matrix(np.zeros((3, 3), np.uint8))


@pytest.mark.parametrize("length,k", [(0, 3), (1, 4), (100, 7), (4096, 6), (4099, 4)])
def test_pad_and_split_matches_reference(length, k):
    payload = _rand(length, length)
    np.testing.assert_array_equal(rs.pad_and_split(payload, k), ref_rs.pad_and_split(payload, k))
    np.testing.assert_array_equal(
        rs.pad_and_split(payload.tobytes(), k), ref_rs.pad_and_split(payload.tobytes(), k)
    )


@pytest.mark.parametrize("n,k", NK)
def test_encode_decode_match_reference(n, k):
    data = _rand(n * k, k, 61)
    coded = rs.encode(_t(data), n).numpy()
    np.testing.assert_array_equal(coded, _ref_encode(data, n))
    rng = np.random.default_rng(n)
    for _ in range(4):
        ids = rng.choice(n, k, replace=False).tolist()
        got = rs.decode(_t(coded[ids]), ids, n, k).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_rs.decode(jnp.asarray(coded[ids]), ids, n, k)))
        np.testing.assert_array_equal(got, data)


def test_systematic_path_permutes_without_inversion():
    n, k = 11, 3
    data = _rand(5, k, 16)
    coded = rs.encode(_t(data), n).numpy()
    before = rs.decode_matrix.cache_info().misses
    for ids in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        np.testing.assert_array_equal(rs.decode(_t(coded[ids]), ids, n, k).numpy(), data)
    assert rs.decode_matrix.cache_info().misses == before


def test_decode_matrix_lru_caches_patterns():
    info0 = rs.decode_matrix.cache_info()
    rs.decode_matrix(10, 4, (0, 2, 5, 9))
    rs.decode_matrix(10, 4, (0, 2, 5, 9))
    info1 = rs.decode_matrix.cache_info()
    assert info1.misses == info0.misses + 1 and info1.hits >= info0.hits + 1


def test_decode_bytes_matches_reference():
    n, k, length = 8, 5, 203
    payload = _rand(3, length).tobytes()
    rows = rs.pad_and_split(payload, k)
    coded = rs.encode(_t(rows), n).numpy()
    ids = [1, 3, 5, 6, 7]
    got = rs.decode_bytes(_t(coded[ids]), ids, n, k, length)
    assert got == payload
    assert got == ref_rs.decode_bytes(jnp.asarray(coded[ids]), ids, n, k, length)


# --------------------------------------------------------------- codec.py


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,k", [(7, 4), (9, 6)])
def test_encode_batch_matches_reference(n, k, backend):
    data = _rand(k, 6, k, 96)
    got = encode_batch(_t(data), n, backend=backend).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_codec.encode_batch(jnp.asarray(data), n)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_batch_bit_exact_every_pattern(backend):
    """ALL C(8, 5) erasure patterns in one batch, vs the reference."""
    n, k = 8, 5
    data = _rand(11, k, 64)
    coded = _ref_encode(data, n)
    pats = [list(p) for p in itertools.combinations(range(n), k)]
    chunks = np.stack([coded[p] for p in pats])
    got = decode_batch(_t(chunks), pats, n, k, backend=backend).numpy()
    want = np.asarray(ref_codec.decode_batch(jnp.asarray(chunks), pats, n, k, backend="ref"))
    np.testing.assert_array_equal(got, want)
    for row in got:
        np.testing.assert_array_equal(row, data)


def test_decode_batch_shape_validation():
    with pytest.raises(ValueError):
        decode_batch(_t(np.zeros((2, 3, 8), np.uint8)), [[0, 1, 2]], 5, 3)
    with pytest.raises(ValueError):
        decode_batch(_t(np.zeros((1, 4, 8), np.uint8)), [[0, 1, 2]], 5, 3)


def test_decode_bank_matches_reference_and_deduplicates():
    n, k = 7, 4
    pats = [[0, 1, 2, 4], [0, 1, 2, 5], [0, 1, 2, 4], [3, 4, 5, 6]] * 5
    bank, idx = codec.decode_bank(n, k, pats, device="cpu")
    ref_bank, ref_idx = ref_codec.decode_bank(n, k, pats)
    assert bank.shape == (3, k, k) and idx.shape == (20,)
    np.testing.assert_array_equal(bank.numpy(), np.asarray(ref_bank))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_host_loop_matches_reference_and_batched():
    n, k = 9, 6
    data = _rand(2, 8, k, 32)
    coded = encode_batch(_t(data), n).numpy()
    rng = np.random.default_rng(3)
    pats = [sorted(rng.choice(n, k, replace=False).tolist()) for _ in range(8)]
    chunks = [coded[i][p] for i, p in enumerate(pats)]
    host = host_loop_decode(chunks, pats, n, k)
    ref_host = ref_codec.host_loop_decode(chunks, pats, n, k)
    batched = decode_batch(_t(np.stack(chunks)), pats, n, k).numpy()
    for i in range(8):
        np.testing.assert_array_equal(host[i], ref_host[i])
        np.testing.assert_array_equal(host[i], batched[i])
        np.testing.assert_array_equal(host[i], data[i])


def _toy_placement():
    """tests/test_codec.py's deterministic 4-file plan on 12 nodes."""
    placement = np.zeros((4, 12), bool)
    placement[0, [0, 1, 2, 3, 8]] = True  # (5, 4)
    placement[1, [0, 4, 5, 6, 7]] = True  # (5, 4)
    placement[2, [1, 2, 3, 8, 9, 10, 11]] = True  # (7, 6)
    placement[3, [2, 3, 4, 5, 8, 9]] = True  # (6, 6): no redundancy
    return placement, [4, 4, 6, 6]


def _plans(placement, k):
    sol = types.SimpleNamespace(n=placement.sum(-1).astype(np.int32), placement=placement)
    return CodecPlan.from_solution(sol, k=k), ref_codec.CodecPlan.from_solution(sol, k=k)


def test_codec_plan_matches_reference_on_toy_plan():
    plan, ref = _plans(*_toy_placement())
    np.testing.assert_array_equal(plan.n, ref.n)
    np.testing.assert_array_equal(plan.k, ref.k)
    assert [(g.n, g.k, g.file_ids.tolist()) for g in plan.groups] == [
        (g.n, g.k, g.file_ids.tolist()) for g in ref.groups
    ]
    assert (plan.r, plan.m) == (ref.r, ref.m) == (4, 12)
    for f in range(4):
        np.testing.assert_array_equal(plan.chunk_nodes(f), ref.chunk_nodes(f))
        assert plan.group_of(f).n == ref.group_of(f).n
    for f, dead in [(0, [0]), (1, [4]), (2, [1]), (0, [8]), (2, [5])]:
        assert plan.degraded_patterns(f, dead) == ref.degraded_patterns(f, dead)
    with pytest.raises(ValueError):  # file 3 has n == k: any loss is fatal
        plan.degraded_patterns(3, [2])
    with pytest.raises(KeyError):
        plan.group_of(9)


def test_from_solution_takes_tensors_and_validates():
    placement, k = _toy_placement()
    sol = types.SimpleNamespace(
        n=torch.from_numpy(placement.sum(-1)), placement=torch.from_numpy(placement)
    )
    plan = CodecPlan.from_solution(sol, torch.tensor(k, dtype=torch.float32))
    np.testing.assert_array_equal(plan.placement, placement)
    assert plan.k.tolist() == k
    bad = types.SimpleNamespace(n=np.asarray([6, 6]), placement=np.ones((2, 6), bool))
    with pytest.raises(ValueError):
        CodecPlan.from_solution(bad, k=[7, 4])  # n < k


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_requests_mixed_groups_round_trip(backend):
    plan, ref = _plans(*_toy_placement())
    rng = np.random.default_rng(7)
    file_ids = [0, 2, 0, 1, 2, 1]
    datas, pats, chunks = [], [], []
    for fid in file_ids:
        g = plan.group_of(fid)
        d = rng.integers(0, 256, (g.k, 48), dtype=np.uint8)
        ids = sorted(rng.choice(g.n, g.k, replace=False).tolist())
        datas.append(d)
        pats.append(ids)
        chunks.append(_ref_encode(d, g.n)[ids])
    out = plan.decode_requests(file_ids, pats, [_t(c) for c in chunks], backend=backend)
    want = ref.decode_requests(file_ids, pats, chunks, backend="ref")
    for got, w, d in zip(out, want, datas):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), d)
    with pytest.raises(ValueError):
        plan.decode_requests(file_ids[:2], pats, chunks)


# -------------------------------------------------------------- repair.py


@pytest.mark.parametrize("dead", [[0], [2], [0, 8], [], [3, 9, 11]])
def test_repair_flow_matches_reference(dead):
    placement, k = _toy_placement()
    avail = np.ones(12, bool)
    avail[dead] = False
    np.testing.assert_array_equal(
        lost_chunk_inventory(placement, ~avail), ref_repair.lost_chunk_inventory(placement, ~avail)
    )
    flow = build_repair_flow(placement, np.asarray(k), avail, 0.05)
    want = ref_repair.build_repair_flow(placement, np.asarray(k), avail, 0.05)
    for name in ("lam", "k", "mask", "lost"):
        np.testing.assert_array_equal(getattr(flow, name), getattr(want, name))
    np.testing.assert_array_equal(flow.pi, want.pi)  # float32 k / count, clamped
    assert flow.active == want.active
    pi0 = np.full((4, 12), 0.25, np.float32)
    lam0 = np.full(4, 0.01)
    for got, w in zip(augment_plan(pi0, lam0, flow), ref_repair.augment_plan(pi0, lam0, want)):
        np.testing.assert_array_equal(got, w)


def test_repair_schedule_matches_reference():
    placement, k = _toy_placement()
    avail = np.ones((5, 12), bool)
    avail[1:3, 0] = False
    avail[2:4, 8] = False
    got = repair_schedule(placement, np.asarray(k), avail, 0.05)
    want = ref_repair.repair_schedule(placement, np.asarray(k), avail, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0].sum(-1), [0.0, 0.05, 0.05, 0.05, 0.0])


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def catalog_plan():
    """The port's own plan for the §V.B catalog cut to r = 64, at fig8's
    settings (theta = 2, eps = 0.01) and the r = 1000 aggregate load."""
    lam, ks, chunk = paper_catalog(r=64)
    lam = np.asarray(lam) * np.float32(1000 / 64)
    ks = np.array(ks)
    eff = float(np.average(chunk, weights=lam))
    cl = tahoe_testbed(device="cpu")
    sol = solve(
        JLCMProblem(lam=torch.from_numpy(lam), k=torch.from_numpy(ks),
                    moments=cl.moments(eff), cost=cl.cost, theta=2.0),
        eps=0.01,
    )
    ref_sol = types.SimpleNamespace(n=sol.n.numpy(), placement=sol.placement.numpy())
    return CodecPlan.from_solution(sol, ks), ref_codec.CodecPlan.from_solution(ref_sol, ks)


def test_catalog_plan_encode_fail_decode_matches_reference(catalog_plan):
    """encode -> node 0 fails -> decode_requests, on the same bytes."""
    plan, ref = catalog_plan
    assert [(g.n, g.k) for g in plan.groups] == [(g.n, g.k) for g in ref.groups]
    rng = np.random.default_rng(64)
    coded, data = {}, {}
    for g in plan.groups:
        rows = np.stack([rs.pad_and_split(rng.integers(0, 256, 1000, np.uint8), g.k)
                         for _ in g.file_ids])
        coded[g.n, g.k] = encode_batch(_t(rows), g.n).numpy()
        np.testing.assert_array_equal(
            coded[g.n, g.k], np.asarray(ref_codec.encode_batch(jnp.asarray(rows), g.n))
        )
        data.update({int(f): rows[i] for i, f in enumerate(g.file_ids)})

    failed = np.zeros(plan.m, bool)
    failed[0] = True
    lost = lost_chunk_inventory(plan.placement, failed)
    np.testing.assert_array_equal(lost, ref_repair.lost_chunk_inventory(ref.placement, failed))
    hurt = np.nonzero(lost)[0].tolist()
    assert hurt, "node 0 holds no chunk of this plan"
    pats, chunks = [], []
    for f in hurt:
        g = plan.group_of(f)
        pats.append(plan.degraded_patterns(f, [0]))
        assert pats[-1] == ref.degraded_patterns(f, [0])
        row = int(np.nonzero(g.file_ids == f)[0][0])
        chunks.append(coded[g.n, g.k][row][pats[-1]])
    assert any(max(p) >= plan.k[f] for p, f in zip(pats, hurt))  # true decodes
    out = plan.decode_requests(hurt, pats, [_t(c) for c in chunks])
    want = ref.decode_requests(hurt, pats, chunks, backend="ref")
    for f, got, w in zip(hurt, out, want):
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), data[f])


# ------------------------------------------- empty extents and views (C1, C2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_n_equals_k_encode_is_the_data_as_in_reference(backend):
    """An n == k group has a (0, k) parity matrix: no redundancy."""
    data = _rand(5, 4, 6, 33)
    got = encode_batch(_t(data), 6, backend=backend).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_codec.encode_batch(jnp.asarray(data), 6)))
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_payload_encodes_as_in_reference(backend):
    from repro.kernels import rs_encode as ref_rs_encode
    from repro_torch.kernels import rs_encode

    rows = rs.pad_and_split(b"", 6)
    assert rows.shape == (6, 0)
    got = rs_encode(_t(rows), 12, backend=backend).numpy()
    want = np.asarray(ref_rs_encode(rows, 12, backend="ref"))
    assert got.shape == want.shape == (12, 0)
    got = encode_batch(_t(np.zeros((3, 6, 0), np.uint8)), 12, backend=backend)
    assert tuple(got.shape) == (3, 12, 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_batch_of_a_sliced_view_matches_reference(backend):
    n, k = 8, 5
    data = _rand(21, 4, k, 64)
    coded = np.stack([_ref_encode(d, n) for d in data])
    chunks = _t(coded)[:, 2:2 + k]
    assert not chunks.is_contiguous()
    pats = [list(range(2, 2 + k))] * len(data)
    got = decode_batch(chunks, pats, n, k, backend=backend).numpy()
    want = np.asarray(ref_codec.decode_batch(jnp.asarray(coded)[:, 2:2 + k], pats, n, k,
                                             backend="ref"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
