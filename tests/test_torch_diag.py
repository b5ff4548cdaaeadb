"""The port's runtime guards (``repro_torch/diag.py``) on the CPU: the
numpy tripwire cases of ``tests/test_diag.py`` with tensors in place of
``jax.Array``, the CUDA sync-debug mode's arming and restoring (with the
CUDA calls replaced by recorders: there is no card here), and the
``REPRO_DIAG=1`` closed-loop contract over the three guarded regions (the
solver's iterations, ``batched_rollout_scores`` and ``simulate_fleet``)."""
import numpy as np
import pytest
import torch

import repro_torch.storage as PS
from repro_torch import diag
from repro_torch.core import JLCMProblem, solve
from repro_torch.serving import AdaptiveReplanner, EwmaMomentEstimator
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LAM = np.asarray([0.030, 0.020, 0.015, 0.012])
K4 = np.asarray([4.0, 4.0, 6.0, 6.0])
CHUNK_MB = 150.0 / 4


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("REPRO_DIAG", "1")


@pytest.fixture
def disarmed(monkeypatch):
    monkeypatch.delenv("REPRO_DIAG", raising=False)


class TestTripwire:
    def test_materializing_a_tensor_raises(self, armed):
        x = torch.arange(4.0)
        with diag.hot_path("t.materialize"):
            with pytest.raises(diag.HostSyncError, match="np.asarray"):
                np.asarray(x)

    @pytest.mark.parametrize("name", ["asarray", "array", "asanyarray", "ascontiguousarray"])
    def test_all_materializer_entry_points_guarded(self, armed, name):
        x = torch.arange(4.0)
        # look the entry point up inside the guard: a reference taken
        # before __enter__ would bypass the patch
        with diag.hot_path("t.entry"):
            with pytest.raises(diag.HostSyncError):
                getattr(np, name)(x)

    def test_numpy_inputs_pass_through(self, armed):
        with diag.hot_path("t.numpy_ok"):
            out = np.asarray([1.0, 2.0])
        np.testing.assert_array_equal(out, [1.0, 2.0])

    def test_disabled_by_default(self, disarmed):
        x = torch.arange(4.0)
        with diag.hot_path("t.off"):
            host = np.asarray(x)  # inert without REPRO_DIAG=1
        assert host.shape == (4,)
        assert not diag.enabled()

    @pytest.mark.parametrize("value", ["1", "true", "on", "yes", " ON "])
    def test_enabled_reads_the_environment_on_every_call(self, monkeypatch, value):
        monkeypatch.setenv("REPRO_DIAG", value)
        assert diag.enabled()
        monkeypatch.setenv("REPRO_DIAG", "0")
        assert not diag.enabled()

    def test_numpy_is_restored_after_exception(self, armed):
        orig = np.asarray
        with pytest.raises(RuntimeError, match="boom"):
            with diag.hot_path("t.restore"):
                raise RuntimeError("boom")
        assert np.asarray is orig

    def test_nested_hot_paths_patch_once_and_restore(self, armed):
        orig = np.asarray
        with diag.hot_path("t.outer"):
            with diag.hot_path("t.inner"):
                with pytest.raises(diag.HostSyncError):
                    np.asarray(torch.zeros(2))
            # still armed after the inner guard exits
            with pytest.raises(diag.HostSyncError):
                np.asarray(torch.zeros(2))
        assert np.asarray is orig

    def test_decorator_form_and_registry(self, armed):
        @diag.hot_path("t.decorated")
        def sync_inside(x):
            return np.asarray(x)

        assert "t.decorated" in diag.hot_path_registry()  # registered at definition
        before = diag.hot_path_registry()["t.decorated"].guarded_calls
        with pytest.raises(diag.HostSyncError):
            sync_inside(torch.arange(3.0))
        stats = diag.hot_path_registry()["t.decorated"]
        assert stats.guarded_calls == before + 1 and stats.calls >= stats.guarded_calls


class _FakeSyncMode:
    """Records ``torch.cuda``'s sync-debug calls; stands in for a card."""

    def __init__(self, monkeypatch):
        self.mode, self.log = 0, []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.log.append(mode)
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)


class TestCudaSyncGuard:
    def test_armed_sets_error_and_restores(self, armed, monkeypatch):
        fake = _FakeSyncMode(monkeypatch)
        with diag.hot_path("t.cuda"):
            assert fake.mode == 2
            with diag.hot_path("t.cuda.inner"):  # re-entrant
                assert fake.mode == 2
            assert fake.mode == 2
        assert fake.mode == 0 and fake.log == ["error", "error", 2, 0]

    def test_restored_after_exception_and_previous_mode_kept(self, armed, monkeypatch):
        fake = _FakeSyncMode(monkeypatch)
        fake.mode = 1  # a caller asked for "warn"
        with pytest.raises(diag.HostSyncError):
            with diag.hot_path("t.cuda.raise"):
                np.asarray(torch.zeros(1))
        assert fake.mode == 1

    def test_disarmed_touches_nothing(self, disarmed, monkeypatch):
        fake = _FakeSyncMode(monkeypatch)
        with diag.hot_path("t.cuda.off"):
            pass
        assert fake.log == []


def test_solver_iterations_are_guarded(armed):
    cl = PS.tahoe_testbed(device="cpu")
    prob = JLCMProblem(lam=torch.tensor(LAM, dtype=torch.float32),
                       k=torch.tensor(K4, dtype=torch.float32),
                       moments=cl.moments(CHUNK_MB), cost=cl.cost, theta=2.0)
    before = diag.hot_path_registry().get("core.solve_merged", diag.HotPathStats("x")).guarded_calls
    sol = solve(prob, max_iters=60)
    stats = diag.hot_path_registry()["core.solve_merged"]
    # one guarded body an iteration; the stop test runs outside the guard
    assert stats.guarded_calls - before == int(sol.iterations)


def test_closed_loop_contract_under_diag(armed):
    """Three replan -> simulate segments and a fleet under REPRO_DIAG=1: no
    guarded hot path materializes a tensor (tests/test_diag.py's
    TestClosedLoopContract, without the compile watcher the port has no
    counterpart for)."""
    cl = PS.tahoe_testbed(device="cpu")
    rp = AdaptiveReplanner(
        k=K4.copy(), cost=cl.cost.numpy(), theta=2.0,
        estimator=EwmaMomentEstimator(prior=cl.moments(CHUNK_MB)),
        max_iters=60, rollout_requests=120,
    )
    avail = np.ones(cl.m, bool)
    carry = PS.init_carry(cl.m, device="cpu")
    d, rates = cl.service_params(CHUNK_MB)
    reg = diag.hot_path_registry()
    before = reg["serving.batched_rollout_scores"].guarded_calls
    for seg in range(3):
        pi = rp.replan(LAM, avail, carry=carry, generator=torch.Generator().manual_seed(40 + seg),
                       pi0=None if seg == 0 else pi)
        assert np.all(np.isfinite(pi))
        carry, res = PS.run_segment_raw(
            carry, torch.Generator().manual_seed(140 + seg), torch.as_tensor(pi),
            torch.tensor(LAM, dtype=torch.float32), d, rates, torch.as_tensor(avail), 120)
        rp.estimator.update(res.obs)
    assert reg["serving.batched_rollout_scores"].guarded_calls - before == 3
    assert len(rp.rollout_walls) == 3
    fleet_before = reg.get("storage.simulate_fleet", diag.HotPathStats("x")).guarded_calls
    fabric = PS.GeoFabric.single_site(cl)
    for stream in (False, True):
        out = PS.simulate_fleet(torch.Generator().manual_seed(1), torch.as_tensor(pi),
                                torch.tensor(LAM, dtype=torch.float32)[None], fabric, CHUNK_MB,
                                200, 3, stream=stream, n_chunks=2 if stream else 1)
        assert torch.isfinite(out.mean_latency())
    assert reg["storage.simulate_fleet"].guarded_calls - fleet_before == 2
