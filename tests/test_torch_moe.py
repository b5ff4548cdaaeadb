"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
local path, on the CPU.

Inputs are made with numpy from a seed; the reference's parameters are
carried across with ``params_from_numpy``. Tolerances:

* ``_route``: the chosen experts equal; weights and the aux loss at atol
  1e-6 (the same float32 softmax and renormalisation in another order).
* ``_dispatch_compute`` and ``moe_apply``: atol 1e-5 (float32 products of
  width 16-64 per expert; the port sums each token's k rows after
  unsorting them, the reference scatter-adds them in sorted order).
* Gradients of ``sum(y * dout) + aux`` against ``jax.grad``: atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models import Model as RefModel
from repro_torch.models import moe, params_from_numpy
from repro_torch.models.config import MoEConfig
from repro_torch.tree import flatten_with_keys
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMOKE = ref_smoke_config("qwen3-moe-30b-a3b")


def _np(x):
    return np.array(x)  # a writable copy, as torch.from_numpy wants


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), _np(ref), atol=atol, rtol=0)


def _x(seed, t, d):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _cfg(n_experts=8, top_k=2, n_shared=0, d_ff=24):
    return dataclasses.replace(
        SMOKE, moe=dataclasses.replace(SMOKE.moe, n_experts=n_experts, top_k=top_k,
                                       d_ff_expert=d_ff, n_shared=n_shared))


def _params(cfg, seed=0):
    ref = ref_moe.moe_init(jax.random.key(seed), cfg, jnp.float32)
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu")


@pytest.mark.parametrize("e,k,t", [(8, 2, 40), (16, 4, 33), (128, 8, 64)])
def test_route_matches_reference(e, k, t):
    mc = MoEConfig(n_experts=e, top_k=k, d_ff_expert=16)
    x = _x(e + k, t, SMOKE.d_model)
    # N(0, 1/d), the router's init distribution (moe_init), so logits are O(1)
    router = (np.random.default_rng(1).standard_normal((SMOKE.d_model, e))
              / np.sqrt(SMOKE.d_model)).astype(np.float32)
    weights, experts, aux = moe._route(torch.from_numpy(x), torch.from_numpy(router), mc)
    rw, re_, raux = ref_moe._route(jnp.asarray(x), jnp.asarray(router), mc)
    np.testing.assert_array_equal(experts.numpy(), _np(re_))
    _close(weights, rw, 1e-6)
    _close(aux, raux, 1e-6)
    assert weights.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("n_local,offset,cap", [(8, 0, None), (3, 2, None), (8, 0, 37)])
def test_dispatch_compute_matches_reference(n_local, offset, cap):
    """The local path (every expert, capacity T*k), a slice of the experts
    at an offset (the others contribute zero) and a capacity that drops."""
    cfg = _cfg()
    ref_p, p = _params(cfg)
    t = 30
    x = _x(7, t, cfg.d_model)
    weights, experts, _ = ref_moe._route(jnp.asarray(x), ref_p["router"], cfg.moe)
    cap = cap or t * cfg.moe.top_k
    sl = slice(offset, offset + n_local)
    want = ref_moe._dispatch_compute(
        jnp.asarray(x), weights, experts, n_local, jnp.int32(offset), cap,
        ref_p["w_gate"][sl], ref_p["w_up"][sl], ref_p["w_down"][sl])
    got = moe._dispatch_compute(
        torch.from_numpy(x), torch.from_numpy(_np(weights)), torch.from_numpy(_np(experts)),
        n_local, offset, cap, p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_matches_reference(n_shared):
    cfg = _cfg(n_shared=n_shared)
    ref_p, p = _params(cfg, seed=n_shared)
    assert ("shared" in p) == bool(n_shared) and p["router"].dtype == torch.float32
    x = _x(3, 2 * 11, cfg.d_model).reshape(2, 11, cfg.d_model)
    want, want_aux = ref_moe.moe_apply(ref_p, jnp.asarray(x), cfg, None)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(got, want, 1e-5)
    _close(aux, want_aux, 1e-6)
    # the combine is deterministic: a second call is bitwise the first
    again, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert torch.equal(again, got)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_gradient_matches_jax_grad(n_shared):
    cfg = _cfg(n_shared=n_shared)
    ref_p, p = _params(cfg, seed=3 + n_shared)
    x = _x(5, 2 * 9, cfg.d_model).reshape(2, 9, cfg.d_model)
    dout = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def ref_loss(params, x):
        y, aux = ref_moe.moe_apply(params, x, cfg, None)
        return jnp.sum(y * dout) + aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    leaves = dict(flatten_with_keys(p))
    for leaf in leaves.values():
        leaf.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(p, xt, cfg)
    loss = torch.sum(y * torch.from_numpy(dout)) + aux
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    _close(grads[0], want_x, 1e-5)
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(want_p)[0]}
    assert want.keys() == leaves.keys()
    for key, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), _np(want[key]), atol=1e-5, rtol=0, err_msg=key)


def test_expert_parallel_island_raises_naming_a20():
    """The island no longer raises: on the local (1, 1) mesh it gives the
    local path's output and aux loss (both of its paths; the gloo world of
    four is ``test_torch_moe_ep.py``'s)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import placements, spec_for_leaf
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import unflatten_like

    cfg = _cfg()
    _, p = _params(cfg)
    mesh = make_local_mesh("cpu")
    ep = moe.EPSpec(mesh=mesh, ep_axis="model", fsdp_axes=("data",), dp_axes=("data",))
    placed = unflatten_like(p, {
        k: distribute_tensor(v, mesh, placements(spec_for_leaf("['moe']" + k, v, mesh), mesh))
        for k, v in flatten_with_keys(p)})
    for t in (4, 1100):  # t * top_k <= 4096: the tiny path; above: ZeRO
        x = torch.from_numpy(_x(t, t, cfg.d_model)).reshape(1, t, -1)
        y, aux = moe.moe_apply(p, x, cfg)
        y_ep, aux_ep = moe.moe_apply(placed, distribute_tensor(x, mesh, [Shard(0), Replicate()]),
                                     cfg, ep=ep)
        assert isinstance(y_ep, DTensor)
        _close(y_ep.full_tensor(), y.numpy(), 1e-6)
        _close(aux_ep.full_tensor(), aux.numpy(), 1e-7)


def test_host_syncs_are_counted_only_for_the_card():
    cfg = _cfg()
    _, p = _params(cfg)
    before = moe._expert_compute.host_syncs
    moe.moe_apply(p, torch.from_numpy(_x(0, 6, cfg.d_model)).reshape(2, 3, -1), cfg)
    assert moe._expert_compute.host_syncs == before


@pytest.mark.parametrize("arch,n_shared", [("qwen3-moe-30b-a3b", 0), ("qwen3-moe-30b-a3b", 1),
                                           ("gemma3-27b", 0)])
def test_params_from_numpy_carries_moe_and_qk_norm_trees(arch, n_shared):
    """A bfloat16 model's tree: the float32 router beside bfloat16 experts,
    ``shared`` when the config has shared experts, and the q/k-norm
    scales, leaf for leaf and bit for bit."""
    cfg = ref_smoke_config(arch)
    if n_shared:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=n_shared))
    ref = RefModel(cfg, dtype=jnp.bfloat16).init(jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = dict(flatten_with_keys(port))
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        ref_leaf = np.asarray(want[key])
        assert str(leaf.dtype).removeprefix("torch.") == str(ref_leaf.dtype), key
        np.testing.assert_array_equal(leaf.float().numpy(), ref_leaf.astype(np.float32),
                                      err_msg=key)
    routers = [k for k in got if k.endswith("['router']")]
    norms = [k for k in got if k.endswith("['q_norm']['scale']") or k.endswith("['k_norm']['scale']")]
    if cfg.moe is not None:
        assert routers and all(got[k].dtype == torch.float32 for k in routers)
        assert any("['shared']" in k for k in got) == bool(n_shared)
        assert got[next(k for k in got if k.endswith("['w_gate']"))].dtype == torch.bfloat16
    assert norms and all(got[k].dtype == torch.bfloat16 for k in norms)
