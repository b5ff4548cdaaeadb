"""RecurrentGemma's RG-LRU block and kernel B4's width pair (256, 256)
against the reference, on the CPU.

Inputs are made with numpy from a seed; the reference's RG-LRU weights
(``rglru_init`` at RecurrentGemma-2B's SMOKE config) are carried across
with ``params_from_numpy``, and the reference runs under ``jax.jit``.
Tolerances:

* ``_causal_conv`` at atol 1e-6 (the same four products, the same order);
* the doubling scan against ``lax.associative_scan`` with the reference's
  combine at atol 1e-6 (float32 products and sums in another order);
* ``rglru_apply`` in train, prefill (its caches) and decode at atol 1e-5,
  and a decode step after a prefill equal to the next row of a longer
  prefill at atol 1e-5;
* the gradients of ``rglru_apply`` against ``jax.grad`` at atol 1e-4 (as
  ``test_torch_train.py``);
* B4's plain twin and ``chunked_sdpa`` at head width 256 (RecurrentGemma's
  local layers: MQA, G = 10 at KH = 1, a sliding window) against the
  reference's lax ``chunked_sdpa`` at atol 2e-5, and the backward against
  ``jax.grad`` at atol 1e-4, as ``test_torch_flash.py``.

The SMOKE model itself (prefill, decode, loss, gradients) is one of
``test_torch_archs.py``'s ``ARCHS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as ref_rglru
import repro_torch.launch.steps as PS
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch.steps import build_model as ref_build_model
from repro.models.attention_opt import chunked_sdpa as ref_chunked_sdpa
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    flash_attention_backward,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.launch.serve import serve
from repro_torch.models import params_from_numpy, rglru
from repro_torch.models.attention_opt import chunked_sdpa
from repro_torch.tree import flatten_with_keys
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ARCH = "recurrentgemma-2b"
CFG = ref_smoke_config(ARCH)
B, T = 2, 37
REF_APPLY = jax.jit(ref_rglru.rglru_apply, static_argnames="mode")
REF_SDPA = jax.jit(ref_chunked_sdpa, static_argnames=("causal", "window", "q_blk", "k_blk"))


def _close(port, ref, atol, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0, **kw)


def _tree_close(port, ref, atol):
    assert set(port) == set(ref)
    for key in ref:
        _close(port[key], ref[key], atol, err_msg=key)


def _params(seed: int = 0, dtype=jnp.float32):
    """The reference's RG-LRU weights, numpy leaves."""
    return jax.tree.map(np.asarray, ref_rglru.rglru_init(jax.random.key(seed), CFG, dtype))


def _both(tree):
    return jax.tree.map(torch.from_numpy, tree), jax.tree.map(jnp.asarray, tree)


def _x(seed: int, t: int = T, width: int | None = None) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, t, width or CFG.d_model)).astype(np.float32)


# ------------------------------------------------------------- the pieces


@pytest.mark.parametrize("carried", [False, True], ids=["zero-tail", "carried-tail"])
def test_causal_conv_matches_reference(carried):
    rng = np.random.default_rng(4)
    lru, cw = CFG.lru_width, CFG.conv_width
    x = rng.standard_normal((B, T, lru)).astype(np.float32)
    w = rng.standard_normal((cw, lru)).astype(np.float32)
    b = rng.standard_normal(lru).astype(np.float32)
    prev = rng.standard_normal((B, cw - 1, lru)).astype(np.float32) if carried else None
    y, tail = rglru._causal_conv(*(None if a is None else torch.from_numpy(a)
                                   for a in (x, w, b, prev)))
    ref_y, ref_tail = ref_rglru._causal_conv(*(None if a is None else jnp.asarray(a)
                                               for a in (x, w, b, prev)))
    _close(y, ref_y, 1e-6)
    _close(tail, ref_tail, 0.0)


@pytest.mark.parametrize("t", [1, 37, 64])
def test_doubling_scan_matches_associative_scan(t):
    """h_t = a_t h_{t-1} + b_t at decays in (0, 1), as the gates give."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.05, 0.999, (B, t, 24)).astype(np.float32)
    b = rng.standard_normal((B, t, 24)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    want = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1)[1])(a, b)
    got = rglru._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, 1e-6)
    h, seq = np.zeros((B, 24), np.float64), []  # and the recurrence itself, in float64
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    _close(got, np.stack(seq, 1), 1e-5)


# ------------------------------------------------------------- rglru_apply


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_rglru_apply_matches_reference(mode):
    p, ref_p = _both(_params(0))
    x = _x(1)
    y, cache = rglru.rglru_apply(p, torch.from_numpy(x), mode)
    ref_y, ref_cache = REF_APPLY(ref_p, jnp.asarray(x), mode=mode)
    _close(y, ref_y, 1e-5)
    if mode == "train":
        assert cache is None and ref_cache is None
    else:
        assert cache["h"].dtype == torch.float32
        _tree_close(cache, ref_cache, 1e-5)


def test_rglru_decode_matches_reference():
    """Decode steps from a carried state and conv tail."""
    p, ref_p = _both(_params(0))
    rng = np.random.default_rng(5)
    cache = {"h": rng.standard_normal((B, CFG.lru_width)).astype(np.float32),
             "conv": rng.standard_normal((B, CFG.conv_width - 1, CFG.lru_width)).astype(
                 np.float32)}
    port_c, ref_c = _both(cache)
    for step in range(3):
        x = _x(10 + step, t=1)
        y, port_c = rglru.rglru_apply(p, torch.from_numpy(x), "decode", port_c)
        ref_y, ref_c = REF_APPLY(ref_p, jnp.asarray(x), mode="decode", cache=ref_c)
        _close(y, ref_y, 1e-5, err_msg=f"step {step}")
        _tree_close(port_c, ref_c, 1e-5)


def test_decode_after_prefill_is_the_next_train_row():
    """A prefill of t tokens then one decode step gives the output of train
    mode's row t and the cache of a prefill of t + 1 tokens."""
    p, _ = _both(_params(1))
    x = torch.from_numpy(_x(2, t=9))
    _, cache = rglru.rglru_apply(p, x[:, :8], "prefill")
    y, stepped = rglru.rglru_apply(p, x[:, 8:], "decode", cache)
    want, _ = rglru.rglru_apply(p, x, "train")
    _, whole = rglru.rglru_apply(p, x, "prefill")
    _close(y, want[:, 8:].numpy(), 1e-5)
    _tree_close(stepped, {k: v.numpy() for k, v in whole.items()}, 1e-5)


def test_rglru_grads_match_jax_grad():
    """Every parameter's gradient and the input's, ``lam`` included."""
    tree = _params(2)
    p, ref_p = _both(tree)
    x = _x(3)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    loss = lambda p, x: jnp.sum(ref_rglru.rglru_apply(p, x, "train")[0] * dy)
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(ref_p, jnp.asarray(x))
    p = {k: v.requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = rglru.rglru_apply(p, xt, "train")
    grads = torch.autograd.grad(y, list(p.values()) + [xt], torch.from_numpy(dy))
    for key, g in zip(list(p) + ["x"], grads):
        _close(g, want_x if key == "x" else want_p[key], 1e-4, err_msg=key)


# ---------------------------------------------------------- parameters


def test_params_from_numpy_carries_an_rglru_tree_with_float32_lam():
    """A bfloat16 RecurrentGemma tree (the model's own init in both
    packages): ``lam`` stays float32 beside bfloat16 leaves, carried bit
    for bit, and the port's init gives the same leaves, shapes and dtypes."""
    ref = ref_build_model(CFG, None, dtype=jnp.bfloat16, remat="none")
    ref_params = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.key(3)))
    carried = params_from_numpy(ref_params, device="cpu")
    own = PS.build_model(CFG, dtype=torch.bfloat16, device="cpu").init(
        torch.Generator().manual_seed(3))
    ref_leaves = {jax.tree_util.keystr(k): v
                  for k, v in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    for tree in (carried, own):
        leaves = dict(flatten_with_keys(tree))
        assert leaves.keys() == ref_leaves.keys()
        for key, leaf in leaves.items():
            assert tuple(leaf.shape) == ref_leaves[key].shape, key
            assert str(leaf.dtype)[6:] == ref_leaves[key].dtype.name, key
    block = carried["stack"]["period"][0]["rglru"]
    assert block["lam"].dtype == torch.float32 and block["w_i"].dtype == torch.bfloat16
    for key, leaf in dict(flatten_with_keys(carried)).items():
        want = ref_leaves[key]
        got = leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        np.testing.assert_array_equal(got, want.view(np.uint16) if want.dtype.name == "bfloat16"
                                      else want, err_msg=key)


def test_init_draws_the_reference_distributions():
    """N(0, 1/fan_in) projections and taps, a zero conv bias, Lambda
    uniform in [2.2, 6.9) in float32, at width 512."""
    cfg = dataclasses.replace(CFG, d_model=512, lru_width=512)
    p = rglru.rglru_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    ref_p = ref_rglru.rglru_init(jax.random.key(0), cfg, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in p.items()} == {
        k: (v.shape, v.dtype.name) for k, v in ref_p.items()}
    lam = p["lam"]
    assert 2.2 <= float(lam.min()) and float(lam.max()) < 6.9
    assert abs(float(lam.mean()) - 4.55) < 0.15
    assert abs(float(p["w_i"].float().std()) * 512**0.5 - 1) < 0.02
    assert abs(float(p["conv_w"].float().std()) * 2 - 1) < 0.1
    assert not bool(p["conv_b"].any())


def test_empty_caches_match_reference_layout():
    """RG-LRU caches (float32 state, the conv's tail) and the local layers'
    caches of ``min(cache_len, window)`` rows, stacked over the period."""
    from test_torch_archs import _tree_close as _caches_close

    ref = ref_build_model(CFG, None, dtype=jnp.float32, remat="none", opt="O3")
    port = PS.build_model(CFG, dtype=torch.float32, remat="none", opt="O3", device="cpu")
    for cache_len in (12, 40):
        _caches_close(port.empty_caches(2, cache_len), ref.empty_caches(2, cache_len), 0.0)


def test_serve_runs_at_smoke_size():
    """``serve("recurrentgemma-2b")`` on the host, a prompt past the smoke
    window of 16 so the local caches roll: the router plans, every batch is
    routed inside pi's support, and greedy decode gives in-range tokens."""
    run = serve(ARCH, device="cpu", n_batches=2, batch=2, prompt_len=20, gen_len=4)
    pi = run.router.pi[0]
    assert np.isfinite(run.router.latency_bound)
    assert all(pi[j] > 0 for r in run.replicas for j in r)
    for toks in run.tokens:
        assert toks.shape == (2, 5) and bool(((toks >= 0) & (toks < CFG.vocab)).all())


# ------------------------------------------------------ B4 at head width 256

# (t, h, kh, window, q_blk, k_blk): MQA with RecurrentGemma's G = 10 and a
# window shorter than T, a ragged last key block, and G = 2 causal
WIDTH_256_CASES = [(40, 10, 1, 16, 16, 16), (53, 10, 1, 20, 1024, 2048),
                   (33, 4, 2, None, 16, 16)]


def _qkv(seed, b, t, h, kh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("t,h,kh,window,q_blk,k_blk", WIDTH_256_CASES)
def test_twin_and_chunked_sdpa_at_head_width_256(t, h, kh, window, q_blk, k_blk):
    q, k, v = _qkv(t + h, 2, t, h, kh, 256)
    scale = 256**-0.5
    kw = dict(causal=True, window=window, q_blk=q_blk, k_blk=k_blk)
    want = REF_SDPA(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, **kw)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    got = chunked_sdpa(*args, scale, **kw)
    assert got.shape == (2, t, h, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    twin = flash_attention_plain(*args, scale=scale, **kw)
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), atol=2e-5)


def test_backward_at_head_width_256_matches_jax_grad():
    """G = 10 at KH = 1 with a window: dq, dk, dv against ``jax.grad`` of
    the reference's ``chunked_sdpa``; the autograd path gives the same."""
    q, k, v = _qkv(7, 1, 30, 10, 1, 256)
    dout = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    scale = 256**-0.5
    kw = dict(causal=True, window=12, q_blk=16, k_blk=16)
    loss = lambda q, k, v: jnp.sum(ref_chunked_sdpa(q, k, v, scale, **kw) * dout)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = chunked_sdpa(qt, kt, vt, scale, **kw)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    direct = flash_attention_backward(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                      torch.from_numpy(dout), scale=scale, causal=True,
                                      window=12, k_blk=16)
    for name, g, d, w in zip("qkv", got, direct, want):
        assert torch.equal(g, d), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=f"d{name}")


def test_kernel_takes_head_width_256():
    """(256, 256) is an instance: a CPU tensor at that width is refused
    for the device, not for the width, and never falls back to the twin."""
    assert (256, 256) in HEAD_DIMS and (256, 128) not in HEAD_DIMS
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 10, 1, 256))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, scale=0.1, window=4)
    with pytest.raises(ValueError, match="not a pair the kernel takes"):
        flash_attention_cuda(q, k, v[..., :128].contiguous(), scale=0.1)
