"""Model building with the reference's optimisation levels, and the train step.

The port of ``repro/launch/steps.py``: ``OPT_LEVELS``, ``build_model``,
``TrainState``, ``make_train_step`` and ``abstract_train_state``. There is
no mesh on one card: the MoE expert island and the ``pin`` knob (GSPMD
batch-sharding constraints) have nothing to act on, so ``pin`` is dropped
and MoE configs build the local path (``ep=None``; the reference's
single-device mesh gives an ep axis of size 1, which drops nothing either);
``remat`` and ``vocab_chunk`` act on the train step. The train step is
eager: one ``torch.autograd.grad`` over the parameter leaves, then
``AdamW.update``. The sharded half (``train_state_shardings``,
``jit_train_step`` and the jitted prefill and decode steps) waits for
``distributed/`` (ROADMAP A20).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import Tensor

from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.storage.cluster import _device
from repro_torch.tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


# The reference's levels (its EXPERIMENTS.md §Perf). O1 and up run train and
# prefill attention on the chunked path, which is kernel B4 on the card.
_O1 = dict(attn_impl="chunked", attn_q_blk=1024, attn_k_blk=2048)
_O2 = dict(_O1, vocab_chunk=32768, pin=True)
OPT_LEVELS: dict[str, dict] = {
    "O0": {},
    "O1": _O1,
    "O2": _O2,
    "O3": dict(_O2, remat="full"),
    "O4": dict(_O2, remat="full", cache_update="dus"),
}


def build_model(
    cfg: ModelConfig,
    *,
    dtype=torch.bfloat16,
    remat: str = "dots",
    opt: str = "O0",
    device="cuda",
) -> Model:
    """A model at optimisation level ``opt`` on ``device``."""
    kw = dict(OPT_LEVELS[opt])
    remat = kw.pop("remat", remat)
    kw.pop("pin", None)
    return Model(cfg=cfg, dtype=dtype, device=_device(device), remat=remat, **kw)


def loss_and_grads(model: Model, params, batch: dict) -> tuple[Tensor, Any]:
    """``jax.value_and_grad(model.loss)``: the loss and a tree of gradients
    shaped like ``params`` (zeros for a leaf the loss does not use)."""
    leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt: AdamW):
    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(model, state.params, batch)
        params, opt_state = opt.update(grads, state.opt, state.params)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return TrainState(params, opt_state), metrics

    return train_step


def abstract_train_state(model: Model, opt: AdamW) -> TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (no memory),
    as the reference's ``jax.eval_shape`` gives them."""
    params = dataclasses.replace(model, device=torch.device("meta")).init(torch.Generator())
    return TrainState(params=params, opt=opt.init(params))
