"""MLA (DeepSeek's multi-head latent attention) and kernel B4's width pair
(q/k 192, v 128) against the reference, on the CPU.

Inputs are made with numpy from a seed; the reference's MLA weights
(``mla_init`` at DeepSeek-V3's SMOKE config) are carried across with
``params_from_numpy``. On the CPU the chunked path runs B4's plain twin.
Tolerances:

* ``mla_apply`` in train, prefill (its compressed caches) and decode mode
  (the absorbed form over the caches, both cache updates), naive and
  chunked: atol 1e-4, as ``test_torch_models.py`` (a few float32 matrix
  products deep, summed in another order);
* B4's plain twin and ``chunked_sdpa`` with a v width other than q's
  (24 / 16 and MLA's 192 / 128), causal, ragged T, G = 1 and 2, against
  the reference's lax ``chunked_sdpa`` (its Pallas kernel takes one width):
  atol 2e-5, as ``test_torch_flash.py``;
* ``flash_attention_backward`` at both width pairs against ``jax.grad`` of
  the reference's ``chunked_sdpa``: atol 1e-4, as ``test_torch_flash.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as ref_layers
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.attention_opt import chunked_sdpa as ref_chunked_sdpa
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    flash_attention_backward,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.models import params_from_numpy
from repro_torch.models import layers
from repro_torch.models.attention_opt import chunked_sdpa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = ref_smoke_config("deepseek-v3-671b")
# the reference's unrolled tiles, traced once a shape rather than run op by op
REF_SDPA = jax.jit(ref_chunked_sdpa, static_argnames=("causal", "window", "q_blk", "k_blk"))
ATOL = 1e-4
B, T, STEPS = 2, 13, 3


def _close(port, ref, atol, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0, **kw)


def _mla_pair(seed: int = 0):
    ref_p = ref_layers.mla_init(jax.random.key(seed), CFG, jnp.float32)
    return ref_p, params_from_numpy(jax.tree.map(np.asarray, ref_p), device="cpu")


def _x(seed: int, t: int = T) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, t, CFG.d_model)).astype(np.float32)


def _run(p, x, mode: str, impl: str, package, cache=None, pos=None, update="onehot",
         cache_len=0):
    lib, arr = (ref_layers, jnp.asarray) if package == "ref" else (layers, torch.from_numpy)
    ctx = lib.Ctx(mode=mode, attn_impl=impl, attn_q_blk=8, attn_k_blk=8, cache_update=update,
                  cache_len=cache_len, decode_pos=None if pos is None else arr(pos))
    return lib.mla_apply(p, arr(x), ctx, CFG, cache=cache)


def test_smoke_config_is_mla_with_a_v_width_of_its_own():
    cfg = get_smoke_config("deepseek-v3-671b")
    m = cfg.mla
    assert cfg.prefix == ("mla_dense",) and cfg.period == ("mla",)
    assert (m.nope_head_dim + m.rope_head_dim, m.v_head_dim) == (24, 16)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_apply_train_and_prefill_match_reference(mode, impl):
    """The output, and in prefill the (c_kv, k_pe) caches laid out for a
    capacity of T + STEPS."""
    ref_p, p = _mla_pair()
    x = _x(1)
    want, want_cache = _run(ref_p, x, mode, impl, "ref", cache_len=T + STEPS)
    got, cache = _run(p, x, mode, impl, "port", cache_len=T + STEPS)
    _close(got, want, ATOL)
    if mode == "train":
        assert cache is None and want_cache is None
        return
    m = CFG.mla
    assert tuple(cache["ckv"].shape) == (B, T + STEPS, m.kv_lora_rank)
    assert tuple(cache["kpe"].shape) == (B, T + STEPS, m.rope_head_dim)
    for key in ("ckv", "kpe"):
        _close(cache[key], want_cache[key], ATOL, err_msg=key)


@pytest.mark.parametrize("impl,update", [("naive", "onehot"), ("chunked", "onehot"),
                                         ("chunked", "dus")])
def test_mla_absorbed_decode_matches_reference(impl, update):
    """Prefill T tokens, then STEPS decode steps in the absorbed form: each
    step's output and the caches it writes, with per-row positions."""
    ref_p, p = _mla_pair(2)
    _, ref_cache = _run(ref_p, _x(3), "prefill", impl, "ref", cache_len=T + STEPS)
    _, cache = _run(p, _x(3), "prefill", impl, "port", cache_len=T + STEPS)
    for step in range(STEPS):
        pos = np.array([T + step, T - 2 + step], np.int32)
        x = _x(10 + step, t=1)
        want, ref_cache = _run(ref_p, x, "decode", impl, "ref", ref_cache, pos, update)
        got, cache = _run(p, x, "decode", impl, "port", cache, pos.astype(np.int64), update)
        _close(got, want, ATOL, err_msg=f"step {step}")
        for key in ("ckv", "kpe"):
            _close(cache[key], ref_cache[key], ATOL, err_msg=f"step {step} {key}")


def test_absorbed_decode_equals_expanded_attention():
    """Decode's latent-space form computes the expanded form's attention:
    decoding every position of a sequence through the caches gives the
    train-mode output at that position (within summation order)."""
    _, p = _mla_pair(4)
    x = _x(5)
    full, _ = _run(p, x, "train", "naive", "port")
    _, cache = _run(p, x[:, :1], "prefill", "naive", "port", cache_len=T)
    for t in range(1, T):
        got, cache = _run(p, x[:, t:t + 1], "decode", "naive", "port", cache,
                          np.full((B,), t, np.int64))
        _close(got[:, 0], full[:, t].detach().numpy(), 1e-5, err_msg=f"position {t}")


# ------------------------------------------------- B4 at a v width of its own

WIDTH_CASES = [  # (hd, vd, t, h, kh, q_blk, k_blk)
    (24, 16, 37, 4, 4, 16, 16), (24, 16, 40, 4, 2, 8, 16), (24, 16, 20, 2, 1, 1024, 1024),
    (192, 128, 33, 2, 2, 16, 16), (192, 128, 50, 4, 2, 1024, 2048), (192, 128, 21, 6, 3, 8, 8),
]


def _qkv(seed, b, t, h, kh, hd, vd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, hd)).astype(np.float32),
            rng.standard_normal((b, t, kh, vd)).astype(np.float32))


@pytest.mark.parametrize("hd,vd,t,h,kh,q_blk,k_blk", WIDTH_CASES)
def test_twin_and_chunked_sdpa_take_a_v_width_of_their_own(hd, vd, t, h, kh, q_blk, k_blk):
    """Causal, ragged T (the last key block padded), G = 1, 2 and 3."""
    q, k, v = _qkv(t * hd + h, 2, t, h, kh, hd, vd)
    scale = 1.0 / np.sqrt(hd)
    want = REF_SDPA(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal=True,
                    q_blk=q_blk, k_blk=k_blk)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    got = chunked_sdpa(*args, scale, causal=True, q_blk=q_blk, k_blk=k_blk)
    assert got.shape == (2, t, h, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    twin = flash_attention_plain(*args, scale=scale, causal=True, q_blk=q_blk, k_blk=k_blk)
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("hd,vd,t,h,kh,blk", [(24, 16, 37, 4, 2, 16), (192, 128, 30, 2, 2, 16)])
def test_backward_at_a_v_width_of_its_own_matches_jax_grad(hd, vd, t, h, kh, blk):
    """dq and dk at q/k's width, dv at v's, against ``jax.grad`` of the
    reference's ``chunked_sdpa``; the autograd path gives the same."""
    q, k, v = _qkv(hd + t, 1, t, h, kh, hd, vd)
    dout = np.random.default_rng(t).standard_normal((1, t, h, vd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    kw = dict(causal=True, q_blk=blk, k_blk=2 * blk)
    loss = lambda q, k, v: jnp.sum(ref_chunked_sdpa(q, k, v, scale, **kw) * dout)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = chunked_sdpa(qt, kt, vt, scale, **kw)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    direct = flash_attention_backward(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                      torch.from_numpy(dout), scale=scale, causal=True,
                                      k_blk=2 * blk)
    for name, g, d, w in zip("qkv", got, direct, want):
        assert g.shape == w.shape
        assert torch.equal(g, d), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=f"d{name}")


def test_kernel_takes_only_its_width_pairs():
    """(192, 128) is an instance; a pair that is not raises before the
    kernel is reached, never falling back to the twin."""
    assert (192, 128) in HEAD_DIMS and (192, 192) not in HEAD_DIMS
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 2, 2, 192, 64))
    with pytest.raises(ValueError, match="not a pair the kernel takes"):
        flash_attention_cuda(q, k, v, scale=0.1)
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 2, 2, 192, 128))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, scale=0.1)
