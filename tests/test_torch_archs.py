"""The five GQA / MoE architectures of head width 128 (Gemma3, the Qwen3
MoE, Qwen2-VL, Phi-4-mini, StarCoder2), DeepSeek-V3 (MLA, a shared
expert beside the routed ones, a leading dense layer) and RecurrentGemma
(RG-LRU layers beside MQA local attention) against the reference, on the
CPU at their SMOKE sizes.

Both packages build each SMOKE config through ``build_model``; the
reference's weights are carried across with ``params_from_numpy``. The
reference runs under ``jax.jit`` (eager, its period scans are traced anew
at every call: 2 s a decode step). On the CPU the chunked path (O1 and up)
runs kernel B4's plain twin. Tolerances:

* prefill, greedy decode and ``forward_logits`` at O0 and O3: equal
  tokens, logits and caches at atol 1e-4 (as ``test_torch_models.py``:
  a few float32 layers deep, summed in another order);
* decode through the caches against teacher forcing: the reference's own
  tolerance, rtol 2e-2 and atol 2e-3 (``tests/test_models.py``);
* ``rope_angles`` / ``apply_rope`` with M-RoPE sections at atol 1e-6.

The training loss and the options alone are in ``test_torch_archs_loss.py``.

Qwen2-VL's batches carry 4 patch embeddings and (3, B, S) positions: a
2 x 2 image grid in the first four slots, text after it.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
import repro.models.layers as ref_layers
from repro.configs.registry import get_smoke_config as ref_smoke_config
import repro_torch.launch.steps as PS
from repro_torch.launch.serve import serve
from repro_torch.models import layers, params_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ARCHS = ("gemma3-27b", "qwen3-moe-30b-a3b", "qwen2-vl-2b", "phi4-mini-3.8b", "starcoder2-15b",
         "deepseek-v3-671b", "recurrentgemma-2b")
ATOL = 1e-4
B = 2


def _close(port, ref, atol=ATOL, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0, **kw)


def _tree_close(port, ref, atol, path="caches"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for key in ref:
            _tree_close(port[key], ref[key], atol, f"{path}.{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _tree_close(p, r, atol, f"{path}[{i}]")
    elif ref is None:
        assert port is None, path
    else:
        assert tuple(port.shape) == tuple(ref.shape), path
        _close(port, ref, atol, err_msg=path)


@functools.cache
def _ref_params(arch: str):
    cfg = ref_smoke_config(arch)
    model = RS.build_model(cfg, None, dtype=jnp.float32, remat="none")
    return jax.jit(model.init)(jax.random.key(zlib.crc32(arch.encode()) % 2**31))


def _pair(arch: str, opt: str, cfg=None):
    cfg = cfg or ref_smoke_config(arch)
    ref = RS.build_model(cfg, None, dtype=jnp.float32, remat="none", opt=opt)
    port = PS.build_model(cfg, dtype=torch.float32, remat="none", opt=opt, device="cpu")
    ref_params = _ref_params(arch) if cfg == ref_smoke_config(arch) else jax.jit(ref.init)(
        jax.random.key(1))
    return ref, port, ref_params, params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                                    device="cpu")


def _positions(s: int, grid: bool) -> np.ndarray:
    """(3, B, s) M-RoPE positions: with ``grid`` a 2 x 2 image in the first
    four slots (t fixed, h and w its row and column), text after it."""
    i = np.arange(s)
    pos = np.stack([i, i, i])
    if grid:
        pos[0, :4], pos[1, :4], pos[2, :4] = 0, i[:4] // 2, i[:4] % 2
    return np.broadcast_to(pos[:, None, :], (3, B, s)).astype(np.int32).copy()


def _batch(cfg, s: int, seed: int = 0, grid: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        batch["patch_embeds"] = (rng.standard_normal((B, 4, cfg.d_model)) * 0.1).astype(
            np.float32)
        batch["positions"] = _positions(s, grid)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


# ------------------------------------------------------------ serve path


def serve_path_matches(arch: str, opt: str, batch: dict, steps: int = 6) -> tuple:
    """Prefill ``batch`` (its tokens the prompt), ``steps`` greedy decode
    steps and ``forward_logits`` in both packages: equal tokens, and logits
    and caches at ``ATOL``. Returns the port's caches after the prefill and
    after the steps."""
    ref, port, ref_params, params = _pair(arch, opt)
    prompt = batch["tokens"].shape[1]
    ref_prefill = jax.jit(ref.prefill, static_argnames="cache_len")
    ref_decode = jax.jit(ref.decode_step)
    ref_logits, ref_caches = ref_prefill(ref_params, _jax(batch), cache_len=prompt + steps)
    logits, caches = port.prefill(params, _torch(batch), cache_len=prompt + steps)
    _close(logits, ref_logits)
    _tree_close(caches, ref_caches, ATOL)
    prefill_caches = caches

    full = port.forward_logits(params, _torch(batch))
    ref_full, _ = jax.jit(ref.forward_logits)(ref_params, _jax(batch))
    _close(full, ref_full)

    ref_tok = jnp.argmax(ref_logits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1)
    for t in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        pos = np.full((B,), prompt + t, np.int32)
        ref_logits, ref_caches = ref_decode(
            ref_params, ref_caches, {"token": ref_tok, "pos": jnp.asarray(pos)})
        logits, caches = port.decode_step(
            params, caches, {"token": tok, "pos": torch.from_numpy(pos).long()})
        _close(logits, ref_logits)
        ref_tok = jnp.argmax(ref_logits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    _tree_close(caches, ref_caches, ATOL)
    return prefill_caches, caches


def decode_tracks_teacher_forcing(arch: str, batch: dict, t0: int = 12) -> None:
    """``tests/test_models.py::test_decode_matches_teacher_forcing`` on the
    port at O3: prefill the first ``t0`` tokens of ``batch``, decode the
    rest through the caches, each step's logits against ``forward_logits``
    of the whole sequence at rtol 2e-2 / atol 2e-3."""
    _, port, _, params = _pair(arch, "O3")
    batch = _torch(batch)
    s = batch["tokens"].shape[1]
    full = port.forward_logits(params, batch).detach()
    pre = {k: (v[..., :t0] if k in ("tokens", "positions") else v) for k, v in batch.items()}
    logits, caches = port.prefill(params, pre, cache_len=s)
    np.testing.assert_allclose(logits.numpy(), full[:, t0 - 1].numpy(), rtol=2e-2, atol=2e-3)
    for t in range(t0, s):
        step = {"token": batch["tokens"][:, t], "pos": torch.full((B,), t)}
        logits, caches = port.decode_step(params, caches, step)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=f"{arch} decode step {t}")


@pytest.mark.parametrize("opt", ["O0", "O3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_greedy_decode_and_forward_match(arch, opt):
    """A 20-token prompt (past Gemma3's and RecurrentGemma's smoke window
    of 16, so their local caches are rolling buffers) and 6 greedy steps."""
    serve_path_matches(arch, opt, _batch(ref_smoke_config(arch), 20))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Prefill 12 tokens, decode 12 more."""
    decode_tracks_teacher_forcing(arch, _batch(ref_smoke_config(arch), 24, seed=7, grid=False))


# ------------------------------------------------------------------ M-RoPE


@pytest.mark.parametrize("sections,rot", [((2, 3, 3), 16), ((16, 24, 24), 128),
                                          ((2, 3, 3), 12)])
def test_rope_angles_with_sections_match_reference(sections, rot):
    rng = np.random.default_rng(rot)
    pos = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, max(rot, 16))).astype(np.float32)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), rot, 1e6, sections)
    rcos, rsin = ref_layers.rope_angles(jnp.asarray(pos), rot, 1e6, sections)
    _close(cos, rcos, 1e-6)
    _close(sin, rsin, 1e-6)
    got = layers.apply_rope(torch.from_numpy(x), cos, sin)
    _close(got, ref_layers.apply_rope(jnp.asarray(x), rcos, rsin), 1e-6)
    # plain rope given (3, B, S) positions reads the t stream, as the reference
    cos, _ = layers.rope_angles(torch.from_numpy(pos), rot, 1e4)
    _close(cos, ref_layers.rope_angles(jnp.asarray(pos), rot, 1e4)[0], 1e-6)


def test_mrope_without_3d_positions_fails_as_in_the_reference():
    pos = np.zeros((2, 4), np.int32)
    with pytest.raises(AssertionError):
        ref_layers.rope_angles(jnp.asarray(pos), 16, 1e4, (2, 3, 3))
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.rope_angles(torch.from_numpy(pos), 16, 1e4, (2, 3, 3))
    # so serve(), which passes no positions, cannot run Qwen2-VL
    with pytest.raises(ValueError, match="M-RoPE"):
        serve("qwen2-vl-2b", device="cpu", n_batches=1, prompt_len=4, gen_len=2)
