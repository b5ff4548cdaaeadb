"""The training loss of the five GQA / MoE architectures of head width 128,
DeepSeek-V3 and RecurrentGemma against the reference, and the options the
port used to refuse, on the CPU at SMOKE sizes (the helpers and the weights of
``test_torch_archs.py``; the reference under ``jax.jit``). Tolerances:

* ``Model.loss`` (with the MoE aux loss) at rtol 2e-4 and its gradients
  against ``jax.grad(model.loss)`` at atol 1e-4 (as ``test_torch_train.py``),
  the aux loss itself at rtol 1e-5;
* ``remat`` "full" and "dots" bitwise "none" on MoE, q/k-norm and RG-LRU
  stacks;
* an MoE layer, q/k norms and M-RoPE sections, each alone on the smoke
  SmolLM: logits at atol 1e-4 and the loss at rtol 2e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch.launch.steps as PS
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.models.config import MoEConfig
from repro_torch.tree import flatten_with_keys
from test_torch_archs import ARCHS, _batch, _close, _jax, _pair, _torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


# ------------------------------------------------------- loss and gradients


def _ref_keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def grads_match(ref, port, ref_params, params, batch: dict, atol=lambda key: 1e-4) -> dict:
    """``Model.loss`` at rtol 2e-4 and every gradient leaf against
    ``jax.grad(ref.loss)`` at ``atol(key)``, the leaf's path (1e-4).
    Returns the port's gradients by path."""
    want, ref_grads = jax.jit(jax.value_and_grad(ref.loss))(ref_params, _jax(batch))
    loss, grads = PS.loss_and_grads(port, params, _torch(batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    ref_grads = _ref_keyed(ref_grads)
    grads = dict(flatten_with_keys(grads))
    assert grads.keys() == ref_grads.keys()
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[key], atol=atol(key), rtol=0,
                                   err_msg=key)
    return grads


@pytest.mark.parametrize("opt", ["O0", "O3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_and_grads_match_reference(arch, opt):
    """O3 is the chunked path (B4's twin and its backward, the vocabulary
    in one chunk) under full remat."""
    ref, port, ref_params, params = _pair(arch, opt)
    batch = _batch(port.cfg, 16, seed=3)
    grads_match(ref, port, ref_params, params, batch)
    if port.cfg.moe is not None:  # the aux loss is in the loss, as the reference's
        _, aux = port._hidden(params, _torch(batch))
        _, ref_aux = jax.jit(ref.forward_logits)(ref_params, _jax(batch))
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


# ------------------------------------------------ the options, one at a time

SMOL = ref_smoke_config("smollm-135m")


@pytest.mark.parametrize("change", [
    dict(period=("moe",), moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)),
    dict(qk_norm=True),
    dict(mrope_sections=(2, 3, 3)),
], ids=["moe", "qk_norm", "mrope_sections"])
def test_options_alone_match_reference(change):
    cfg = dataclasses.replace(SMOL, **change)
    ref, port, ref_params, params = _pair("smollm-135m", "O0", cfg)
    batch = _batch(cfg, 12, seed=5)
    got = port.forward_logits(params, _torch(batch))
    want, _ = jax.jit(ref.forward_logits)(ref_params, _jax(batch))
    _close(got, want)
    np.testing.assert_allclose(float(port.loss(params, _torch(batch))),
                               float(jax.jit(ref.loss)(ref_params, _jax(batch))), rtol=2e-4)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma3-27b", "recurrentgemma-2b"])
def test_remat_covers_moe_and_qk_norm_layers_bitwise(arch):
    """``remat`` "full" and "dots" recompute MoE, q/k-norm and RG-LRU layers as they
    do the others: the loss (aux included) and every gradient bitwise
    "none"'s on the CPU, which recomputes the same ops in the same order."""
    _, port, _, params = _pair(arch, "O0")
    batch = _torch(_batch(port.cfg, 16, seed=4))
    loss, grads = PS.loss_and_grads(port, params, batch)
    for remat in ("full", "dots"):
        got, got_grads = PS.loss_and_grads(dataclasses.replace(port, remat=remat), params,
                                           batch)
        assert torch.equal(got, loss), remat
        for (key, g), (_, want) in zip(flatten_with_keys(got_grads), flatten_with_keys(grads)):
            assert torch.equal(g, want), (remat, key)
