"""RWKV6-1.6B's attention-free block and model against the reference, on the
CPU at its SMOKE size.

Both packages build the SMOKE config (3 RWKV6 layers, d 64, head size 16,
d_ff 128) through ``build_model``; the reference's weights are carried
across with ``params_from_numpy`` and the reference runs under ``jax.jit``
(the helpers and weights of ``test_torch_archs.py``). Tolerances:

* ``_wkv_scan`` (the reference's ``lax.scan``, here a loop over T) and
  ``rwkv_apply`` in train, prefill and decode at atol 1e-5 (float32 state,
  the head's products summed in another order); a decode step against the
  next step of a scan at atol 1e-5;
* prefill, greedy decode and ``forward_logits`` at O0 and O3, caches
  included, at atol 1e-4;
* decode against teacher forcing at the reference's rtol 2e-2 / atol 2e-3;
* ``loss`` at rtol 2e-4, dense and chunked over the vocabulary
  (``test_torch_archs_loss.py``'s tolerance); each gradient leaf at atol
  1e-4 or, where the reference's own leaf moves by more when the embedding
  is nudged up by one float32 ulp, within that movement. The per-head
  groupnorm divides by the WKV output's RMS, and at random weights that
  makes the leaves feeding r, k and u ill-conditioned: there one ulp on
  the embedding moves the reference's own gradients by more than 1e-4,
  and the port must differ from the reference by less than that movement.
  The widened leaves are the embedding, ``bonus_u``, ``ln_tm``, ``mix``,
  ``w_k`` and ``w_r``; each moves by about 4e-4 of its largest entry, and
  the test checks that the leaf scaled by 1.1, or zeroed, still fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as ref_rwkv
import repro_torch.launch.steps as PS
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch.steps import build_model as ref_build_model
from repro_torch.launch.serve import serve
from repro_torch.models import params_from_numpy, rwkv6
from repro_torch.tree import flatten_with_keys
from test_torch_archs import (B, _batch, _close, _jax, _pair, _tree_close,
                              decode_tracks_teacher_forcing, serve_path_matches)
from test_torch_archs_loss import _ref_keyed, grads_match
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ARCH = "rwkv6-1.6b"
CFG = ref_smoke_config(ARCH)
ATOL = 1e-4
N_H, HD = CFG.d_model // CFG.rwkv_head_size, CFG.rwkv_head_size


def _block_params(seed: int = 0):
    """One layer's parameters of the reference's SMOKE model, numpy leaves."""
    _, _, ref_params, _ = _pair(ARCH, "O0")
    return jax.tree.map(lambda a: np.asarray(a[seed]), ref_params["stack"]["period"][0]["rwkv"])


def _both(tree):
    return jax.tree.map(torch.from_numpy, tree), jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------ the recurrence


def test_wkv_scan_matches_reference():
    rng = np.random.default_rng(0)
    shape = (B, 9, N_H, HD)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    u = (rng.standard_normal((N_H, HD)) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((B, N_H, HD, HD)).astype(np.float32)
    (o, s), (ref_o, ref_s) = (
        rwkv6._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, s0))),
        jax.jit(ref_rwkv._wkv_scan)(*map(jnp.asarray, (r, k, v, w, u, s0))))
    _close(o, ref_o, 1e-5)
    _close(s, ref_s, 1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rwkv_apply_matches_reference(mode):
    """The block with its token shifts, decay LoRA, groupnorm and channel
    mix; decode from a carried state and shifts."""
    p, ref_p = _both(_block_params())
    rng = np.random.default_rng(1)
    t = 1 if mode == "decode" else 11
    x = rng.standard_normal((B, t, CFG.d_model)).astype(np.float32)
    cache = None
    if mode == "decode":
        cache = {"state": rng.standard_normal((B, N_H, HD, HD)).astype(np.float32),
                 "shift_tm": rng.standard_normal((B, CFG.d_model)).astype(np.float32),
                 "shift_cm": rng.standard_normal((B, CFG.d_model)).astype(np.float32)}
    port_cache, ref_cache = _both(cache) if cache else (None, None)
    y, new = rwkv6.rwkv_apply(p, torch.from_numpy(x), CFG, mode, port_cache)
    ref_y, ref_new = jax.jit(ref_rwkv.rwkv_apply, static_argnums=(2, 3))(
        ref_p, jnp.asarray(x), CFG, mode, ref_cache)
    _close(y, ref_y, 1e-5)
    _tree_close(new, ref_new, 1e-5, "rwkv cache")


def test_decode_step_is_the_next_scan_step():
    """A prefill of t tokens then one decode step gives the output and the
    cache of a prefill of t + 1 tokens."""
    p, _ = _both(_block_params(1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 8, CFG.d_model)).astype(np.float32))
    _, cache = rwkv6.rwkv_apply(p, x[:, :7], CFG, "prefill")
    y, stepped = rwkv6.rwkv_apply(p, x[:, 7:], CFG, "decode", cache)
    want, whole = rwkv6.rwkv_apply(p, x, CFG, "prefill")
    _close(y, want[:, 7:].numpy(), 1e-5)
    _tree_close(stepped, jax.tree.map(lambda a: a.numpy(), whole), 1e-5, "rwkv cache")


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("opt", ["O0", "O3"])
def test_prefill_greedy_decode_and_forward_match(opt):
    """A 20-token prompt and 6 greedy steps; the caches are the state and
    the two token shifts."""
    serve_path_matches(ARCH, opt, _batch(CFG, 20))


def test_decode_matches_teacher_forcing():
    """Prefill 12 tokens, decode 12 more through the state."""
    decode_tracks_teacher_forcing(ARCH, _batch(CFG, 24, seed=7))


@pytest.mark.parametrize("opt,vocab_chunk", [("O0", None), ("O3", None), ("O0", 96)],
                         ids=["O0-dense", "O3-chunked", "O0-chunked-96"])
def test_loss_and_grads_match_reference(opt, vocab_chunk):
    """Dense CE at O0; O3's one vocabulary chunk under full remat; 96-wide
    chunks, the last ragged. Every leaf's gradient, the float32 ``decay_w0``
    and ``bonus_u`` included, at atol 1e-4 or within the reference's own
    movement under a one-ulp nudge of the embedding (module docstring).
    A widened leaf's tolerance stays under 0.1 % of its largest entry, and
    that leaf scaled by 1.1 or zeroed must fail it."""
    ref, port, ref_params, params = _pair(ARCH, opt)
    if vocab_chunk is not None:
        ref = dataclasses.replace(ref, vocab_chunk=vocab_chunk)
        port = dataclasses.replace(port, vocab_chunk=vocab_chunk)
    batch = _batch(CFG, 16, seed=3)
    ref_grad = jax.jit(jax.grad(ref.loss))
    nudged = dict(ref_params, embed=jnp.nextafter(ref_params["embed"], jnp.inf))
    want, moved = _ref_keyed(ref_grad(ref_params, _jax(batch))), _ref_keyed(
        ref_grad(nudged, _jax(batch)))
    moved = {key: float(np.abs(g - want[key]).max()) for key, g in moved.items()}
    atol = lambda key: max(ATOL, moved[key])
    grads = grads_match(ref, port, ref_params, params, batch, atol=atol)
    for key in (key for key in moved if moved[key] > ATOL):  # the widened leaves
        scale = float(np.abs(want[key]).max())
        assert moved[key] <= 1e-3 * scale, key  # widened by under 0.1 % of the leaf's largest
        # planted faults: the leaf scaled by 1.1, or zeroed, falls outside its tolerance
        for fault in (1.1 * grads[key].numpy(), np.zeros_like(want[key])):
            assert float(np.abs(fault - want[key]).max()) > atol(key), key


def test_empty_caches_match_reference_layout():
    ref, port, _, _ = _pair(ARCH, "O3")
    _tree_close(port.empty_caches(2, 20), ref.empty_caches(2, 20), 0.0)


# ------------------------------------------------------ parameters, serving


def test_init_and_params_from_numpy_keep_float32_leaves_in_bfloat16():
    """In a bfloat16 model ``decay_w0`` and ``bonus_u`` stay float32: in the
    port's own init (shapes and dtypes leaf for leaf the reference's) and
    carried across from the reference's tree bit for bit."""
    ref = ref_build_model(CFG, None, dtype=jnp.bfloat16, remat="none")
    ref_params = jax.jit(ref.init)(jax.random.key(3))
    carried = params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")
    port = PS.build_model(CFG, dtype=torch.bfloat16, device="cpu")
    own = port.init(torch.Generator().manual_seed(3))
    ref_leaves = _ref_keyed(ref_params)
    for tree in (carried, own):
        leaves = dict(flatten_with_keys(tree))
        assert leaves.keys() == ref_leaves.keys()
        for key, leaf in leaves.items():
            want = ref_leaves[key]
            assert tuple(leaf.shape) == want.shape, key
            assert str(leaf.dtype)[6:] == want.dtype.name, key
    block = carried["stack"]["period"][0]["rwkv"]
    assert block["decay_w0"].dtype == block["bonus_u"].dtype == torch.float32
    assert block["w_r"].dtype == torch.bfloat16
    for key, leaf in dict(flatten_with_keys(carried)).items():
        want = ref_leaves[key]
        got = leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        np.testing.assert_array_equal(got, want.view(np.uint16) if want.dtype.name == "bfloat16"
                                      else want, err_msg=key)


def test_init_draws_the_reference_distributions():
    """Uniform [0, 1) mixes, w0 ~ -4 + N(0, 0.3²), u ~ N(0, 0.3²),
    N(0, 1/fan_in) projections, unit norm scales, at d 512."""
    cfg = dataclasses.replace(CFG, d_model=512, d_ff=1024, rwkv_head_size=64)
    p = rwkv6.rwkv_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    ref_p = ref_rwkv.rwkv_init(jax.random.key(0), cfg, jnp.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in ref_p.items()}
    assert 0 <= float(p["mix"].min()) and float(p["mix"].max()) < 1
    assert abs(float(p["mix"].mean()) - 0.5) < 0.02
    assert abs(float(p["decay_w0"].mean()) + 4) < 0.05
    assert abs(float(p["decay_w0"].std()) - 0.3) < 0.03
    assert abs(float(p["bonus_u"].std()) - 0.3) < 0.03
    assert abs(float(p["w_r"].std()) * 512**0.5 - 1) < 0.02
    assert abs(float(p["cm_v"].std()) * 1024**0.5 - 1) < 0.02
    assert torch.equal(p["ln_scale"], torch.ones(8, 64))


def test_serve_runs_at_smoke_size():
    """``serve("rwkv6-1.6b")`` on the host: the router plans, every batch
    is routed inside pi's support, and greedy decode gives in-range tokens."""
    run = serve(ARCH, device="cpu", n_batches=2, batch=2, prompt_len=8, gen_len=4)
    pi = run.router.pi[0]
    assert np.isfinite(run.router.latency_bound)
    assert all(pi[j] > 0 for r in run.replicas for j in r)
    for toks in run.tokens:
        assert toks.shape == (2, 5) and bool(((toks >= 0) & (toks < CFG.vocab)).all())
    assert len(run.latencies) == 2 and all(lat > 0 for lat in run.latencies)
