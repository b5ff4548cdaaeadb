"""The port's serving slice against the reference, on the CPU.

``exponential_moments`` at rtol 1e-5 (as ``tests/test_torch_core.py``);
``Router.plan`` within the solver parity tolerances of
``tests/test_torch_slice.py`` (pi within atol 1e-3, the bound within rtol
1e-3); ``Router.route`` exactly, on the uniform the reference draws from
its key. ``serve`` runs end to end at smoke size. The last test holds the
port to its rule: nothing under ``src/repro_torch/`` and no line of
``chip_smoke.py`` imports JAX or the reference package.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.queueing as ref_q
from repro.serving import ReplicaPool as RefPool
from repro.serving import Router as RefRouter
from repro_torch.core import exponential_moments
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch.serve import serve
from repro_torch.serving import ReplicaPool, Router
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
MU = np.array([1.3, 1.1, 0.8, 0.5], np.float32)


def test_exponential_moments_match():
    got = exponential_moments(torch.from_numpy(MU))
    want = ref_q.exponential_moments(jnp.asarray(MU))
    for name in ("mu", "m2", "m3"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5)
    assert got.mu.dtype == torch.float32


def _pools():
    ref = RefPool(moments=ref_q.exponential_moments(jnp.asarray(MU)), cost=jnp.ones(4))
    port = ReplicaPool(moments=exponential_moments(torch.from_numpy(MU)), cost=torch.ones(4))
    return ref, port


@pytest.mark.parametrize("load", [0.3, 0.6])
def test_plan_matches_reference(load):
    """theta = 0, as ``serve`` plans."""
    ref_pool, pool = _pools()
    rates = np.array([load * MU.sum()], np.float32)
    ref = RefRouter.plan(ref_pool, jnp.asarray(rates))
    port = Router.plan(pool, torch.from_numpy(rates))
    assert pool.m == 4 and port.pi.shape == (1, 4)
    np.testing.assert_allclose(port.pi, np.asarray(ref.pi), atol=1e-3)
    np.testing.assert_allclose(port.latency_bound, ref.latency_bound, rtol=1e-3)


def test_plan_with_replica_cost_matches_reference():
    """At theta = 0.5 the cost term drops the slowest replica on both sides,
    and the bound agrees within rtol 1e-3. pi itself is not compared: both
    solvers stop by their relative test in a flat valley of the objective
    (objectives 2.89746 and 2.89752), at points 1.4e-3 apart."""
    ref_pool, pool = _pools()
    rates = np.array([0.3 * MU.sum()], np.float32)
    ref = RefRouter.plan(ref_pool, jnp.asarray(rates), theta=0.5)
    port = Router.plan(pool, torch.from_numpy(rates), theta=0.5)
    np.testing.assert_array_equal(port.pi > 1e-3, np.asarray(ref.pi) > 1e-3)
    assert port.pi[0, 3] == 0.0
    np.testing.assert_allclose(port.latency_bound, ref.latency_bound, rtol=1e-3)


@pytest.mark.parametrize("hedge", [0, 1])
def test_route_matches_reference_on_a_shared_uniform(hedge):
    """Madow sampling on the uniform the reference's key gives: the same
    replicas, 1 + hedge of them, all in pi's support."""
    ref_pool, pool = _pools()
    pi = np.array([[0.45, 0.3, 0.25, 0.0], [0.1, 0.2, 0.3, 0.4]], np.float32)
    ref = RefRouter(pool=ref_pool, pi=pi, hedge=hedge)
    port = Router(pool=pool, pi=pi, hedge=hedge)
    for seed in range(24):
        key = jax.random.key(seed)
        cls = seed % 2
        u = float(jax.random.uniform(key, (), dtype=jnp.float32))
        got = port.route(cls, u=u)
        assert got == ref.route(key, cls)
        assert len(got) == 1 + hedge and len(set(got)) == len(got)
        if hedge == 0:
            assert all(pi[cls, j] > 0 for j in got)


def test_route_draws_from_a_generator():
    _, pool = _pools()
    port = Router(pool=pool, pi=np.array([[0.5, 0.5, 0.0, 0.0]], np.float32))
    picks = [port.route(0, generator=torch.Generator().manual_seed(s))[0] for s in range(200)]
    assert set(picks) == {0, 1}
    assert 70 < picks.count(0) < 130


def test_serve_smoke_on_the_host():
    before = flash_attention_cuda.launches
    run = serve(device="cpu", smoke=True, n_batches=2, prompt_len=12, gen_len=5)
    assert len(run.latencies) == len(run.replicas) == 2
    assert all(np.isfinite(run.latencies)) and min(run.latencies) > 0
    pi = run.router.pi[0]
    assert np.isfinite(run.router.latency_bound)
    assert all(pi[j] > 0 for r in run.replicas for j in r)
    vocab = run.model.cfg.vocab
    for prompt, toks in zip(run.prompts, run.tokens):
        assert prompt.shape == (4, 12) and toks.shape == (4, 6)
        assert bool(((toks >= 0) & (toks < vocab)).all())
    assert run.model.attn_impl == "chunked"  # O3: prefill on B4's path
    assert flash_attention_cuda.launches == before  # the host runs the twin


def test_serve_asks_for_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(n_batches=1)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    assert {"scenarios", "checkpoint", "optim", "data"} <= {path.parent.name for path in files}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
