"""The port's AdamW, schedule and gradient compression against the reference.

``repro_torch.optim`` against ``repro.optim`` on the CPU, on one parameter
tree (dicts, a list and a tuple of float32 leaves) and gradients made with
numpy from a seed: three ``update`` steps with and without global-norm
clipping, at a fixed rate and on the cosine schedule, at rtol 1e-6 on the
parameters, both moments and the step; ``global_norm`` and the schedule
alone; bfloat16 parameters (moments in float32) to one bfloat16 ulp; and
two steps of ``compress_decompress``, bitwise on the reconstructed
gradients, the error feedback and the int8 codes they carry. The
reference's ``compress_decompress`` splits its (grad, error) pairs with
``is_leaf=isinstance(x, tuple)``, which also catches a tuple container, so
its tree holds dicts and lists only, as the models' parameter trees do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as RO
import repro_torch.optim as PO
from repro_torch.models import params_from_numpy
from repro_torch.tree import flatten_with_keys
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-6
SHAPES = {"embed": (6, 4), "stack": [(4, 5), (5,)], "head": ((3, 4), (2, 2, 2))}


def _tree(rng, scale=1.0):
    leaf = lambda shape: (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": leaf(SHAPES["embed"]),
            "stack": [leaf(s) for s in SHAPES["stack"]],
            "head": tuple(leaf(s) for s in SHAPES["head"])}


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(port, ref, rtol=RTOL, atol=0.0):
    ref = {jax.tree_util.keystr(k): np.asarray(v)
           for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    port = dict(flatten_with_keys(port))
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        got = port[key]
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("clip", [1.0, None, 0.05])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_three_steps_match_reference(clip, schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.3) for _ in range(3)]
    lr_ref = RO.cosine_schedule(3e-2, warmup=1, total=3) if schedule else 3e-2
    lr_port = PO.cosine_schedule(3e-2, warmup=1, total=3) if schedule else 3e-2
    ref_opt = RO.AdamW(lr=lr_ref, weight_decay=0.01, clip_norm=clip)
    port_opt = PO.AdamW(lr=lr_port, weight_decay=0.01, clip_norm=clip)
    ref_p, p = _as_jax(params), params_from_numpy(params, device="cpu")
    ref_s, s = ref_opt.init(ref_p), port_opt.init(p)
    assert s.step.dtype == torch.int32 and s.step.shape == ()
    for g in grads:
        ref_p, ref_s = ref_opt.update(_as_jax(g), ref_s, ref_p)
        p, s = port_opt.update(params_from_numpy(g, device="cpu"), s, p)
        _assert_trees_close(p, ref_p)
        _assert_trees_close(s.m, ref_s.m)
        _assert_trees_close(s.v, ref_s.v)
        assert int(s.step) == int(ref_s.step)
    assert isinstance(p["head"], tuple) and isinstance(p["stack"], list)
    assert isinstance(s, PO.AdamWState)


def test_adamw_bfloat16_params_match_reference_to_an_ulp():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.3) for _ in range(3)]
    bf16 = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), t)
    tbf16 = lambda t: jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16), t)
    ref_opt, port_opt = RO.AdamW(lr=1e-2), PO.AdamW(lr=1e-2)
    ref_p, p = bf16(params), tbf16(params)
    ref_s, s = ref_opt.init(ref_p), port_opt.init(p)
    for g in grads:
        ref_p, ref_s = ref_opt.update(bf16(g), ref_s, ref_p)
        p, s = port_opt.update(tbf16(g), s, p)
    assert all(leaf.dtype == torch.bfloat16 for _, leaf in flatten_with_keys(p))
    assert all(leaf.dtype == torch.float32 for _, leaf in flatten_with_keys(s.m))
    _assert_trees_close(p, ref_p, rtol=2**-7)
    _assert_trees_close(s.v, ref_s.v, rtol=1e-5)


def test_global_norm_and_schedule_match_reference():
    tree = _tree(np.random.default_rng(2))
    got = PO.global_norm(params_from_numpy(tree, device="cpu"))
    np.testing.assert_allclose(float(got), float(RO.global_norm(_as_jax(tree))), rtol=RTOL)
    ref, port = RO.cosine_schedule(3e-3, 20, 200), PO.cosine_schedule(3e-3, 20, 200)
    for step in (0, 1, 19, 20, 21, 100, 199, 200, 250):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(port(torch.tensor(step, dtype=torch.int32))), want,
                                   rtol=RTOL)


def test_compress_decompress_two_steps_bitwise():
    rng = np.random.default_rng(3)
    no_tuple = lambda t: dict(t, head=list(t["head"]))
    params = no_tuple(_tree(rng))
    grads = [no_tuple(_tree(rng, scale=0.2)) for _ in range(2)]
    ref_c = RO.compress_init(_as_jax(params))
    c = PO.compress_init(params_from_numpy(params, device="cpu"))
    for g in grads:
        error = dict(flatten_with_keys(c.error))
        ref_g, ref_c = RO.compress_decompress(_as_jax(g), ref_c)
        got, c = PO.compress_decompress(params_from_numpy(g, device="cpu"), c)
        _assert_trees_close(got, ref_g, rtol=0.0)
        _assert_trees_close(c.error, ref_c.error, rtol=0.0)
        # equal outputs carry equal int8 codes: each is q * scale, with the
        # scale of g + error and q an integer in [-127, 127]
        g_port = dict(flatten_with_keys(params_from_numpy(g, device="cpu")))
        for key, deq in flatten_with_keys(got):
            scale = torch.max(torch.abs(g_port[key] + error[key])) / 127.0 + 1e-12
            codes = torch.round(deq / scale)
            assert codes.abs().max() <= 127 and torch.equal(codes * scale, deq), key
    assert isinstance(c, PO.CompressionState)
