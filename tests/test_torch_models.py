"""The port's model plane against the reference, on the CPU at smoke size.

Layer primitives are compared at atol 1e-6 (float32, the same operations in
the same order up to XLA's and PyTorch's last-bit rounding). The SMOKE
SmolLM is built on both sides through ``build_model``, with the reference's
weights carried across by ``params_from_numpy``: prefill logits and caches
at atol 1e-4, then greedy decode steps with equal tokens and logits at
atol 1e-4 (30-odd float32 matmuls deep, summed in another order).
On the CPU the chunked path runs kernel B4's plain twin.
"""
import dataclasses
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as ref_layers
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch.steps import OPT_LEVELS as REF_OPT_LEVELS
from repro.launch.steps import build_model as ref_build_model
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.launch.steps import OPT_LEVELS, build_model
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import layers
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-4


def _close(port, ref, atol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


PORTED = ("smollm-135m", "starcoder2-15b", "phi4-mini-3.8b", "gemma3-27b",
          "qwen3-moe-30b-a3b", "deepseek-v3-671b", "qwen2-vl-2b", "seamless-m4t-medium",
          "recurrentgemma-2b", "rwkv6-1.6b")


def test_every_registered_arch_is_ported():
    from repro.configs.registry import ARCHS as REF_ARCHS

    assert sorted(ARCHS) == sorted(REF_ARCHS) == sorted(PORTED)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_and_opt_levels_equal_the_reference(arch):
    from repro.configs.registry import get_config as ref_get_config

    asdict = dataclasses.asdict
    assert asdict(get_config(arch)) == asdict(ref_get_config(arch))
    assert asdict(get_smoke_config(arch)) == asdict(ref_smoke_config(arch))
    assert OPT_LEVELS == REF_OPT_LEVELS


@pytest.mark.parametrize("get", [get_config, get_smoke_config])
def test_unknown_arch_raises(get):
    with pytest.raises(KeyError, match="unknown arch"):
        get("no-such-model")


def test_rope_and_rmsnorm_match():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    for rot in (16, 12):
        cos, sin = layers.rope_angles(torch.from_numpy(pos), rot, 1e4)
        rcos, rsin = ref_layers.rope_angles(jnp.asarray(pos), rot, 1e4)
        _close(cos, rcos, 1e-6)
        _close(sin, rsin, 1e-6)
        got = layers.apply_rope(torch.from_numpy(x), cos, sin)
        _close(got, ref_layers.apply_rope(jnp.asarray(x), rcos, rsin), 1e-6)
    scale = rng.standard_normal(16).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    _close(got, ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6), 1e-6)


@pytest.mark.parametrize("mode", ["onehot", "dus"])
def test_write_kv_matches(mode):
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 5, 7], np.int32)
    got = layers._write_kv(torch.from_numpy(cache), torch.from_numpy(new),
                           torch.from_numpy(pos), mode)
    want = ref_layers._write_kv(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos), mode)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("t,s", [(5, 5), (5, 9), (11, 4)])
def test_to_cache_layout_matches(t, s):
    x = np.random.default_rng(t * s).standard_normal((2, t, 3, 4)).astype(np.float32)
    got = layers._to_cache_layout(torch.from_numpy(x), s)
    _close(got, ref_layers._to_cache_layout(jnp.asarray(x), s), 1e-6)


# ------------------------------------------------------------ whole model

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
        _close(port, ref, atol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {key: _shapes(val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(val) for val in tree)
    return tuple(tree.shape)


SMOKE = ref_smoke_config("smollm-135m")
CONFIGS = {
    "smollm": SMOKE,
    # a sliding-window layer beside a global one: the windowed prefill, the
    # rolling decode buffer, a prefix / suffix around the period, partial
    # rotary and an untied head
    "local": dataclasses.replace(SMOKE, n_layers=6, prefix=("attn",), suffix=("dense",),
                                 period=("local", "attn"), window=8, rotary_pct=0.75,
                                 tie_embeddings=False),
}


@pytest.mark.parametrize("opt", ["O3", "O0", "O4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_smoke_model_prefill_and_greedy_decode_match(name, opt):
    cfg = CONFIGS[name]
    ref = ref_build_model(cfg, None, dtype=jnp.float32, remat="none", opt=opt)
    port = build_model(cfg, dtype=torch.float32, remat="none", opt=opt, device="cpu")
    assert port.attn_impl == ref.attn_impl and port.cache_update == ref.cache_update
    ref_params = ref.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), device="cpu")

    b, prompt, steps = 2, 12, 8
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, prompt)).astype(np.int32)
    ref_logits, ref_caches = ref.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                         cache_len=prompt + steps)
    logits, caches = port.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                                  cache_len=prompt + steps)
    _close(logits, ref_logits, ATOL)
    _tree_close(caches, ref_caches, ATOL)

    full = port.forward_logits(params, {"tokens": torch.from_numpy(toks).long()})
    ref_full, _ = ref.forward_logits(ref_params, {"tokens": jnp.asarray(toks)})
    _close(full, ref_full, ATOL)

    ref_tok = jnp.argmax(ref_logits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1)
    for t in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        pos = np.full((b,), prompt + t, np.int32)
        ref_logits, ref_caches = ref.decode_step(
            ref_params, ref_caches, {"token": ref_tok, "pos": jnp.asarray(pos)})
        logits, caches = port.decode_step(
            params, caches, {"token": tok, "pos": torch.from_numpy(pos).long()})
        _close(logits, ref_logits, ATOL)
        ref_tok = jnp.argmax(ref_logits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    _tree_close(caches, ref_caches, ATOL)


def test_empty_caches_match_reference_layout():
    cfg = CONFIGS["local"]
    ref = ref_build_model(cfg, None, dtype=jnp.float32, opt="O3")
    port = build_model(cfg, dtype=torch.float32, opt="O3", device="cpu")
    _tree_close(port.empty_caches(2, 20), ref.empty_caches(2, 20), 0.0)


def test_init_draws_the_reference_distributions():
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg, dtype=torch.float32, opt="O3", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ref_params = ref_build_model(cfg, None, dtype=jnp.float32, opt="O3").init(jax.random.key(0))
    assert _shapes(params) == _shapes(ref_params)
    wq = params["stack"]["period"][0]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim_)
    assert abs(float(wq.std()) * cfg.d_model**0.5 - 1.0) < 0.05
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    assert torch.equal(params["ln_f"]["scale"], torch.ones(cfg.d_model))


def test_model_accepts_every_kind_of_the_reference_and_no_other():
    from repro.models.config import LayerKind as RefLayerKind
    from repro_torch.models.stack import PORTED_KINDS

    assert set(typing.get_args(RefLayerKind)) <= set(PORTED_KINDS)
    for kind in PORTED_KINDS:
        Model(cfg=dataclasses.replace(SMOKE, period=(kind,)), device="cpu")
    cfg = dataclasses.replace(SMOKE, period=("no-such-kind",))
    with pytest.raises(NotImplementedError, match="no-such-kind"):
        Model(cfg=cfg, device="cpu")


def test_unported_attention_impl_raises():
    """Every attention impl of the reference builds, the dry-run's "stub"
    probe included; one the reference lacks raises."""
    for impl in ("naive", "chunked", "stub"):
        Model(cfg=SMOKE, device="cpu", attn_impl=impl)
    with pytest.raises(ValueError, match="flash"):
        Model(cfg=SMOKE, device="cpu", attn_impl="flash")
