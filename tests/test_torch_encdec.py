"""The encoder-decoder (SeamlessM4T-medium) against the reference, on the
CPU at its SMOKE size.

Both packages build the SMOKE config (2 encoder + 2 decoder layers, d 64,
4 heads of 16) through ``build_model``; the reference's weights are carried
across with ``params_from_numpy`` and the reference runs under ``jax.jit``
(the helpers and weights of ``test_torch_archs.py``). Batches carry the
stub frontend's ``enc_embeds`` (B, 24, 64) x 0.1, as
``tests/test_models.py`` builds them. Tolerances:

* ``_bidirectional_attn`` and cross ``attn_apply`` in train, prefill and
  decode at atol 1e-5 (float32, a few products summed in another order);
* prefill, greedy decode and ``forward_logits`` at O0 and O3 (the decoder's
  self-attention on kernel B4's plain twin), caches included, at atol 1e-4,
  and the cross cache after decode bitwise the prefill's;
* decode against teacher forcing at the reference's rtol 2e-2 / atol 2e-3;
* ``loss`` at rtol 2e-4 and its gradients at atol 1e-4, dense and chunked
  over the vocabulary (``test_torch_archs_loss.py``'s tolerances).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as ref_layers
import repro.models.stack as ref_stack
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch.serve import serve as ref_serve
from repro_torch.launch.serve import serve
from repro_torch.models import layers, stack
from test_torch_archs import (B, _batch, _close, _pair, _tree_close,
                              decode_tracks_teacher_forcing, serve_path_matches)
from test_torch_archs_loss import grads_match
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ARCH = "seamless-m4t-medium"
CFG = ref_smoke_config(ARCH)
ATOL = 1e-4


def _enc_batch(s: int, seed: int) -> dict:
    batch = _batch(CFG, s, seed)
    rng = np.random.default_rng(seed + 100)
    batch["enc_embeds"] = (rng.standard_normal((B, CFG.encoder_seq, CFG.d_model)) * 0.1).astype(
        np.float32)
    return batch


def _attn_params(cfg, seed: int) -> dict:
    """An ``attn_init`` tree of numpy leaves (with q/k norm scales off 1)."""
    rng = np.random.default_rng(seed)
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    shapes = dict(wq=(d, h * hd), wk=(d, kh * hd), wv=(d, kh * hd), wo=(h * hd, d))
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)}
    return p


# --------------------------------------------------------------- the layers


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_bidirectional_attn_matches_reference(rotary_pct):
    """RoPE over the whole head width whatever ``rotary_pct``, all keys
    visible."""
    cfg = dataclasses.replace(CFG, rotary_pct=rotary_pct)
    p = _attn_params(cfg, 0)
    h = np.random.default_rng(1).standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    got = stack._bidirectional_attn(jax.tree.map(torch.from_numpy, p), torch.from_numpy(h), cfg)
    want = ref_stack._bidirectional_attn(jax.tree.map(jnp.asarray, p), jnp.asarray(h),
                                         ref_layers.Ctx(mode="train"), cfg)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attn_apply_matches_reference(mode, qk_norm):
    """Cross-attention: K/V from the encoder memory (from the cross cache
    in decode, with no k norm there), no RoPE, every encoder slot visible;
    prefill's cache is the K/V at the encoder's length."""
    cfg = dataclasses.replace(CFG, qk_norm=qk_norm)
    rng = np.random.default_rng(2)
    p = _attn_params(cfg, 3)
    t = 1 if mode == "decode" else 10
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    kv = (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim_)
    cache = ({"k": rng.standard_normal(kv).astype(np.float32),
              "v": rng.standard_normal(kv).astype(np.float32)} if mode == "decode" else None)
    pos = np.full((B,), 7, np.int32)
    ctx = layers.Ctx(mode=mode, enc_out=torch.from_numpy(enc), cache_len=16,
                     decode_pos=torch.from_numpy(pos).long())
    ref_ctx = ref_layers.Ctx(mode=mode, enc_out=jnp.asarray(enc), cache_len=16,
                             decode_pos=jnp.asarray(pos))
    y, new = layers.attn_apply(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), ctx, cfg,
                               cache=jax.tree.map(torch.from_numpy, cache), cross=True)
    ref_y, ref_new = ref_layers.attn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), ref_ctx,
                                           cfg, cache=jax.tree.map(jnp.asarray, cache), cross=True)
    _close(y, ref_y, 1e-5)
    _tree_close(new, ref_new, 1e-5, "cross cache")
    if mode == "prefill":
        assert tuple(new["k"].shape) == kv
    if mode == "decode":  # the cache comes back as it went in
        assert new["k"] is not None and torch.equal(new["k"], torch.from_numpy(cache["k"]))


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("opt", ["O0", "O3"])
def test_prefill_greedy_decode_and_forward_match(opt):
    """A 20-token prompt and 6 greedy steps; the cross caches at the
    encoder's length, and after decode bitwise the prefill's."""
    prefill_caches, caches = serve_path_matches(ARCH, opt, _enc_batch(20, 0))
    cross = prefill_caches["period"][0]["cross"]
    assert tuple(cross["k"].shape) == (CFG.n_layers, B, CFG.encoder_seq, CFG.n_kv_heads,
                                       CFG.head_dim_)
    for key in ("k", "v"):
        assert torch.equal(caches["period"][0]["cross"][key], cross[key])


def test_decode_matches_teacher_forcing():
    """Prefill 12 tokens, decode 12 more."""
    decode_tracks_teacher_forcing(ARCH, _enc_batch(24, 7))


@pytest.mark.parametrize("opt,vocab_chunk", [("O0", None), ("O3", None), ("O0", 96)],
                         ids=["O0-dense", "O3-chunked", "O0-chunked-96"])
def test_loss_and_grads_match_reference(opt, vocab_chunk):
    """Dense CE at O0; O3's one vocabulary chunk under full remat (the
    encoder's layers recomputed too); 96-wide chunks, the last ragged.
    Every leaf's gradient, the encoder's included."""
    ref, port, ref_params, params = _pair(ARCH, opt)
    if vocab_chunk is not None:
        ref = dataclasses.replace(ref, vocab_chunk=vocab_chunk)
        port = dataclasses.replace(port, vocab_chunk=vocab_chunk)
    grads = grads_match(ref, port, ref_params, params, _enc_batch(16, 3))
    assert any(key.startswith("['encoder']") for key in grads)


def test_empty_caches_match_reference_layout():
    ref, port, _, _ = _pair(ARCH, "O3")
    _tree_close(port.empty_caches(2, 20), ref.empty_caches(2, 20), 0.0)


def test_serve_fails_for_want_of_enc_embeds_in_both_packages():
    """``serve`` passes tokens only, so the encoder finds no
    ``enc_embeds``: a ``KeyError`` in both packages, before any step."""
    with pytest.raises(KeyError, match="enc_embeds"):
        ref_serve(ARCH, n_batches=1, prompt_len=4, gen_len=2)
    with pytest.raises(KeyError, match="enc_embeds"):
        serve(ARCH, device="cpu", n_batches=1, prompt_len=4, gen_len=2)
