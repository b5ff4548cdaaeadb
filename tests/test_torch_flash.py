"""Kernel B4's plain twin against the reference's flash attention.

On the CPU the port's ``flash_attention`` runs its plain twin (the online
softmax over k blocks in eager PyTorch) and never the CUDA kernel;
``chip_smoke.py`` holds kernel B4 to that twin on the card. Here the twin is
held to the reference's Pallas kernel in interpret mode, as
``tests/test_kernels.py::TestFlashAttention`` runs it, with that test's
tolerances: atol 2e-5 in float32 (the two sum the scores in another order)
and 3e-2 in bfloat16. Inputs are made with numpy from a seed.

The wrapper is a ``torch.autograd.Function``; its backward
(``flash_attention_backward``, torch ops over key blocks, the same code on
both devices) is held to ``jax.grad`` of the reference's ``chunked_sdpa``
(causal, windowed, GQA) at atol 1e-4, the tolerance of
``tests/test_perf_opts.py::TestChunkedSDPA::test_grad_matches``, and to
autograd through the plain twin where the reference's chunked path has no
counterpart (key padding, Tq != Tk, rows with every key masked, bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention_opt import chunked_sdpa as ref_chunked_sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.models.attention_opt import chunked_sdpa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _qkv(seed, b, tq, h, kh, hd, tk=None):
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    return (
        rng.standard_normal((b, tq, h, hd)).astype(np.float32),
        rng.standard_normal((b, tk, kh, hd)).astype(np.float32),
        rng.standard_normal((b, tk, kh, hd)).astype(np.float32),
    )


def _both(q, k, v, **kw):
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw
    )
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize(
    "t,h,kh,hd,blk",
    [(32, 2, 2, 8, 8), (64, 4, 2, 16, 16), (48, 8, 4, 32, 16), (50, 4, 1, 16, 16)],
)
def test_causal_sweep_matches_pallas(t, h, kh, hd, blk):
    q, k, v = _qkv(t, 2, t, h, kh, hd)
    got, want = _both(q, k, v, scale=1.0 / hd**0.5, causal=True, q_blk=blk, k_blk=blk)
    assert got.shape == (2, t, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("window", [8, 24])
def test_sliding_window_matches_pallas(window):
    q, k, v = _qkv(window, 1, 64, 4, 2, 16)
    got, want = _both(q, k, v, scale=0.25, causal=True, window=window, q_blk=16, k_blk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_bf16_matches_pallas():
    q, k, v = _qkv(5, 1, 32, 2, 2, 16)
    to_bf16 = lambda x: (jnp.asarray(x).astype(jnp.bfloat16),
                         torch.from_numpy(x).to(torch.bfloat16))
    (qj, qt), (kj, kt), (vj, vt) = map(to_bf16, (q, k, v))
    want = flash_attention_pallas(qj, kj, vj, scale=0.25, causal=True, q_blk=16, k_blk=16,
                                  interpret=True)
    got = flash_attention(qt, kt, vt, scale=0.25, causal=True, q_blk=16, k_blk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=3e-2
    )


@pytest.mark.parametrize(
    "t,h,kh,window,dtype",
    [(32, 4, 2, None, "float32"), (32, 6, 2, 8, "float32"), (37, 12, 2, None, "float32"),
     (32, 16, 2, 12, "float32"), (30, 24, 2, None, "float32"), (32, 24, 8, 16, "bfloat16")],
)
def test_head_width_128_matches_pallas(t, h, kh, window, dtype):
    """hd = 128, the width of the five GQA models, at their groups G = H / KH
    (2, 3, 6, 8, 12), causal and windowed, a ragged T, and bfloat16."""
    q, k, v = _qkv(t * h, 1, t, h, kh, 128)
    kw = dict(scale=128**-0.5, causal=True, window=window, q_blk=16, k_blk=16)
    if dtype == "float32":
        got, want = _both(q, k, v, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        return
    (qj, qt), (kj, kt), (vj, vt) = ((jnp.asarray(x).astype(jnp.bfloat16),
                                     torch.from_numpy(x).to(torch.bfloat16)) for x in (q, k, v))
    want = flash_attention_pallas(qj, kj, vj, interpret=True, **kw)
    got = flash_attention(qt, kt, vt, **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize(
    "tq,tk,window",
    [(24, 40, None), (40, 24, None), (40, 24, 8), (36, 36, 4)],
)
def test_ragged_and_unequal_lengths_match_pallas(tq, tk, window):
    """Tq != Tk and key padding: padded keys are masked by the causal test
    only, and rows whose every key is masked get the reference's answer."""
    q, k, v = _qkv(tq * 100 + tk, 2, tq, 6, 2, 16, tk=tk)
    got, want = _both(q, k, v, scale=0.25, causal=True, window=window, q_blk=16, k_blk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_non_causal_without_padding_matches_pallas():
    q, k, v = _qkv(7, 2, 32, 4, 2, 8)
    got, want = _both(q, k, v, scale=0.3, causal=False, q_blk=16, k_blk=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_non_causal_padding_raises_as_the_reference():
    q, k, v = _qkv(3, 1, 50, 2, 2, 8)
    with pytest.raises(ValueError, match="non-causal padding"):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
                               causal=False, q_blk=16, k_blk=16, interpret=True)
    with pytest.raises(ValueError, match="non-causal padding"):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        scale=0.3, causal=False, q_blk=16, k_blk=16)


@pytest.mark.parametrize(
    "t,blk,window",
    [(16, 1024, None), (40, 16, None), (64, 16, 8), (37, 8, 12)],
)
def test_chunked_sdpa_matches_reference(t, blk, window):
    q, k, v = _qkv(t + blk, 2, t, 4, 2, 16)
    want = ref_chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                            causal=True, window=window, q_blk=blk, k_blk=2 * blk)
    got = chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.25,
                       causal=True, window=window, q_blk=blk, k_blk=2 * blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_chunked_sdpa_non_causal_ragged_matches_reference():
    """The reference's chunked path tiles a ragged non-causal key axis
    without padding; the port runs it as one key block."""
    q, k, v = _qkv(11, 1, 37, 4, 2, 16)
    want = ref_chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                            causal=False, q_blk=16, k_blk=16)
    got = chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.25,
                       causal=False, q_blk=16, k_blk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_cpu_tensors_run_the_twin_and_never_build(monkeypatch):
    def refuse():
        raise AssertionError("the kernel was built for CPU tensors")

    monkeypatch.setattr(fa, "load_library", refuse)
    before = flash_attention_cuda.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 16, 2, 1, 8))
    got = flash_attention(q, k, v, scale=0.3)
    want = flash_attention_plain(q, k, v, scale=0.3)
    assert torch.equal(got, want)
    assert flash_attention_cuda.launches == before


def test_kernel_refuses_cpu_tensors_and_other_widths():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 16, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, scale=0.3)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k[:, :, :, :4], v, scale=0.3)


# ------------------------------------------------------------------ backward


def _grads(fn, q, k, v, dout):
    """dq, dk, dv of ``sum(fn(q, k, v) * dout)`` by torch autograd."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))


@pytest.mark.parametrize(
    "b,t,h,kh,hd,blk,window",
    [(2, 40, 4, 2, 16, 8, None), (1, 64, 4, 2, 16, 16, 8), (2, 37, 6, 2, 8, 8, 12),
     (1, 32, 4, 1, 16, 8, None), (1, 24, 2, 2, 8, 1024, None)],
)
def test_backward_matches_jax_grad_of_reference_chunked_sdpa(b, t, h, kh, hd, blk, window):
    q, k, v = _qkv(t * 7 + h, b, t, h, kh, hd)
    dout = np.random.default_rng(t).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, q_blk=blk, k_blk=2 * blk)
    loss = lambda q, k, v: jnp.sum(ref_chunked_sdpa(q, k, v, 0.25, **kw) * dout)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _grads(lambda q, k, v: chunked_sdpa(q, k, v, 0.25, **kw), q, k, v, dout)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize(
    "tq,tk,window,causal",
    [(24, 40, None, True), (40, 24, None, True), (40, 24, 8, True), (36, 36, 4, True),
     (50, 50, 8, True), (32, 32, None, False)],
)
def test_backward_matches_autograd_through_the_plain_twin(tq, tk, window, causal):
    """Key padding (k_blk 16 over 24, 36, 40 or 50 keys), Tq != Tk, rows whose
    every key is masked (Tq > Tk with a window) and a non-causal call."""
    q, k, v = _qkv(tq + tk, 2, tq, 6, 2, 16, tk=tk)
    dout = np.random.default_rng(tq).standard_normal(q.shape).astype(np.float32)
    kw = dict(scale=0.25, causal=causal, window=window, q_blk=16, k_blk=16)
    got = _grads(lambda q, k, v: flash_attention(q, k, v, **kw), q, k, v, dout)
    want = _grads(lambda q, k, v: flash_attention_plain(q, k, v, **kw), q, k, v, dout)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, err_msg=f"d{name}")


def test_backward_in_bfloat16_follows_the_plain_twin():
    q, k, v = _qkv(9, 1, 32, 4, 2, 16)
    dout = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    kw = dict(scale=0.25, causal=True, window=12, q_blk=16, k_blk=16)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        qt, kt, vt = bf(q), bf(k), bf(v)
        out = fn(qt, kt, vt, **kw)
        grads.append(torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout).to(out.dtype)))
    for g, w in zip(*grads):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), atol=5e-2, rtol=2e-2)


def test_backward_calls_no_plain_twin(monkeypatch):
    q, k, v = _qkv(4, 1, 16, 2, 1, 8)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, scale=0.3, q_blk=8, k_blk=8)

    def refuse(*args, **kwargs):
        raise AssertionError("the backward called the plain twin")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    dq, dk, dv = torch.autograd.grad(out.sum(), (qt, kt, vt))
    want = flash_attention_backward(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                    torch.ones_like(out), scale=0.3, k_blk=8)
    assert all(torch.equal(g, w) for g, w in zip((dq, dk, dv), want))
