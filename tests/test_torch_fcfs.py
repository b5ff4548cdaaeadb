"""The port's FCFS scan against the reference's ``ref`` backend.

On the CPU the port's ``fcfs_scan`` runs its plain twin, the loop of
(S, m) tensor ops that the CUDA kernel is held to bitwise on the card
(``chip_smoke.py``, phase 2). Inputs are made with numpy from a seed and
handed to both packages. Latency and ``dep`` must match bitwise, as the
reference's own backends do; ``busy`` to rtol 1e-6, the bound
``tests/test_fleet_parity.py`` uses for the reference's backends.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fcfs_queue import fcfs_scan as ref_fcfs_scan
from repro_torch.kernels import fcfs_queue
from repro_torch.kernels.fcfs_queue import fcfs_scan, fcfs_scan_plain
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _workload(seed, s, n, m, p_empty=0.1):
    """Random (t, masks, service) with ~p_empty all-false mask rows."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(size=(s, n)), axis=-1).astype(np.float32)
    masks = rng.random((s, n, m)) < 0.5
    masks &= ~(rng.random((s, n)) < p_empty)[..., None]
    service = (0.01 + 0.05 * rng.exponential(size=(s, n, m))).astype(np.float32)
    return t, masks, service


def _both(t, masks, service, dep0=None, busy0=None):
    ref = ref_fcfs_scan(
        jnp.asarray(t), jnp.asarray(masks), jnp.asarray(service),
        None if dep0 is None else jnp.asarray(dep0),
        None if busy0 is None else jnp.asarray(busy0),
        backend="ref",
    )
    port = fcfs_scan(
        torch.from_numpy(t), torch.from_numpy(masks), torch.from_numpy(service),
        None if dep0 is None else torch.from_numpy(dep0),
        None if busy0 is None else torch.from_numpy(busy0),
    )
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


def _assert_parity(ref, port):
    np.testing.assert_array_equal(ref[0], port[0])  # latency, -inf rows too
    np.testing.assert_array_equal(ref[1], port[1])  # dep
    np.testing.assert_allclose(ref[2], port[2], rtol=1e-6)  # busy


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("s,n,m", [(1, 64, 4), (5, 128, 6), (16, 32, 3)])
def test_plain_matches_reference(seed, s, n, m):
    ref, port = _both(*_workload(seed, s, n, m))
    _assert_parity(ref, port)
    assert np.isneginf(port[0]).any()  # empty service sets are exercised


@pytest.mark.parametrize("s,n,m", [(4, 96, 5), (5, 128, 6)])
def test_plain_matches_reference_with_carried_state(s, n, m):
    """Chunked-horizon contract: queue state carried in from an earlier call."""
    rng = np.random.default_rng(9)
    dep0 = rng.exponential(size=(s, m)).astype(np.float32)
    busy0 = rng.exponential(size=(s, m)).astype(np.float32)
    ref, port = _both(*_workload(3, s, n, m), dep0, busy0)
    _assert_parity(ref, port)


def test_unbatched_matches_reference_and_batched_row():
    t, masks, service = _workload(4, 1, 50, 4)
    ref, port = _both(t[0], masks[0], service[0])
    assert port[0].shape == (50,) and port[1].shape == (4,)
    _assert_parity(ref, port)
    _, batched = _both(t, masks, service)
    np.testing.assert_array_equal(batched[0][0], port[0])


def test_empty_service_set_is_neg_inf_and_leaves_queues():
    t = np.array([1.0, 2.0, 3.0], np.float32)
    masks = np.array([[1, 0], [0, 0], [0, 1]], bool)
    service = np.full((3, 2), 0.5, np.float32)
    ref, port = _both(t, masks, service)
    assert port[0][1] == -np.inf
    np.testing.assert_array_equal(port[1], [1.5, 3.5])
    _assert_parity(ref, port)


def test_uint8_masks_match_bool_masks():
    t, masks, service = _workload(5, 3, 40, 5)
    as_bool = fcfs_scan(*map(torch.from_numpy, (t, masks, service)))
    as_u8 = fcfs_scan(
        torch.from_numpy(t), torch.from_numpy(masks.astype(np.uint8)),
        torch.from_numpy(service),
    )
    for a, b in zip(as_bool, as_u8):
        assert torch.equal(a, b)


def test_any_nonzero_mask_byte_counts_as_true():
    """uint8 masks hold any byte where a node serves, as the reference reads them."""
    t, masks, service = _workload(6, 4, 64, 12)
    rng = np.random.default_rng(7)
    as_bytes = masks.astype(np.uint8) * rng.integers(1, 256, masks.shape, dtype=np.uint8)
    assert (as_bytes > 1).any()
    ref, port = _both(t, as_bytes, service)
    _assert_parity(ref, port)
    _, as_bool = _both(t, masks, service)
    for a, b in zip(as_bool, port):
        np.testing.assert_array_equal(a, b)


def test_cpu_tensors_never_build_the_kernel(monkeypatch):
    """The plain twin runs because the tensors are on the CPU, not because
    a build failed: the library loader is never reached."""

    def refuse():
        raise AssertionError("the CPU path must not build or load the kernel")

    monkeypatch.setattr(fcfs_queue, "load_library", refuse)
    before = fcfs_scan.launches
    fcfs_scan(*map(torch.from_numpy, _workload(6, 2, 16, 3)))
    assert fcfs_scan.launches == before


def test_other_devices_raise_instead_of_falling_back():
    t, masks, service = (
        torch.from_numpy(x).to("meta") for x in _workload(7, 2, 8, 3)
    )
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fcfs_scan(t, masks, service)


def test_plain_twin_handles_zero_requests():
    t = torch.zeros((2, 0))
    masks = torch.zeros((2, 0, 3), dtype=torch.bool)
    service = torch.zeros((2, 0, 3))
    dep0 = torch.ones((2, 3))
    lat, dep, busy = fcfs_scan_plain(t, masks, service, dep0, torch.zeros((2, 3)))
    assert lat.shape == (2, 0)
    assert torch.equal(dep, dep0)


def test_strided_views_match_contiguous_and_reference():
    """A view (every other request, every other node) runs as its copy."""
    t, masks, service = _workload(9, 3, 64, 8)
    view = fcfs_scan(torch.from_numpy(t)[:, ::2], torch.from_numpy(masks)[:, ::2, ::2],
                     torch.from_numpy(service)[:, ::2, ::2])
    ref, port = _both(np.ascontiguousarray(t[:, ::2]), np.ascontiguousarray(masks[:, ::2, ::2]),
                      np.ascontiguousarray(service[:, ::2, ::2]))
    _assert_parity(ref, [x.numpy() for x in view])
    _assert_parity(port, [x.numpy() for x in view])
