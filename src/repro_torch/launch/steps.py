"""Model building with the reference's optimisation levels, and the train,
prefill and decode steps, unsharded and sharded.

The port of ``repro/launch/steps.py``. ``build_model(cfg, mesh)`` wires a
model for a mesh as the reference's does: an MoE config on a mesh with a
``model`` axis gets the expert-parallel island (``EPSpec``), and the
``pin`` knob of O2 and up pins the batch dim at attention to the mesh's DP
axes. The train step is eager: one ``torch.autograd.grad`` over the
parameter leaves, then ``AdamW.update``.

The sharded half (``train_state_shardings``, ``jit_train_step``,
``jit_prefill_step``, ``jit_decode_step``) keeps the reference's names and
return tuples, with DTensor placements where the reference has
``NamedSharding``s. Each returned step is an eager function over DTensors
(nothing is compiled): it places its state and batch at the rules'
placements (``distribute_tensor`` for a plain tensor, ``redistribute`` for
a DTensor elsewhere), runs the unsharded step's code by DTensor's sharding
propagation, and returns the state (or caches) at the same placements and
the metrics replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    batch_specs,
    cache_shardings,
    mesh_axes,
    param_shardings,
)
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import EPSpec
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.storage.cluster import _device
from repro_torch.tree import flatten_with_keys, tree_leaves, tree_map, tree_unflatten, unflatten_like


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
    mesh=None,
    *,
    dtype=torch.bfloat16,
    remat: str = "dots",
    opt: str = "O0",
    device="cuda",
) -> Model:
    """A model at optimisation level ``opt`` on ``device``, wired for
    ``mesh`` (a ``DeviceMesh``, or None): the EP island for MoE archs."""
    ep = None
    if cfg.moe is not None and mesh is not None and "model" in mesh.mesh_dim_names:
        dp = mesh_axes(mesh)["dp"]
        ep = EPSpec(mesh=mesh, ep_axis="model", fsdp_axes=dp or ("data",), dp_axes=dp or ("data",))
    kw = dict(OPT_LEVELS[opt])
    remat = kw.pop("remat", remat)
    if kw.pop("pin", False) and mesh is not None:
        kw["pin_mesh"] = mesh
        kw["pin_axes"] = mesh_axes(mesh)["dp"]
    return Model(cfg=cfg, dtype=dtype, device=_device(device), ep=ep, remat=remat, **kw)


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
    params = _abstract_params(model)
    return TrainState(params=params, opt=opt.init(params))


# ------------------------------------------------------------------ sharded
def place(tree, shardings):
    """``tree`` with each leaf at its ``NamedSharding`` in ``shardings`` (a
    tree of the same structure): a plain tensor through
    ``distribute_tensor`` (every rank must hold the same full value), a
    DTensor through ``redistribute`` when its placements differ."""
    sh = dict(flatten_with_keys(shardings))

    def one(key, leaf):
        mesh, want = sh[key].mesh, sh[key].placements
        if isinstance(leaf, DTensor):
            return leaf if tuple(leaf.placements) == want else leaf.redistribute(mesh, want)
        return distribute_tensor(leaf, mesh, want)

    return unflatten_like(tree, {key: one(key, leaf) for key, leaf in flatten_with_keys(tree)})


def gather(tree):
    """``tree`` with every DTensor leaf as its full (global) tensor."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _replicated(mesh):
    return (Replicate(),) * mesh.ndim


def train_state_shardings(abstract: TrainState, mesh) -> TrainState:
    """Shardings for a train state: parameters and both moments by the
    rules, the step replicated."""
    return TrainState(
        params=param_shardings(abstract.params, mesh),
        opt=AdamWState(
            step=NamedSharding(mesh, P()),
            m=param_shardings(abstract.opt.m, mesh),
            v=param_shardings(abstract.opt.v, mesh),
        ),
    )


def _batch_shardings(batch_sds: dict, mesh) -> dict:
    return {k: NamedSharding(mesh, s) for k, s in batch_specs(batch_sds, mesh).items()}


def jit_train_step(model: Model, opt: AdamW, mesh, batch_sds: dict):
    """Returns (step, abstract_state, state_shardings, batch_shardings).
    ``step(state, batch)`` gives the new state at ``state_shardings`` and
    replicated metrics."""
    abstract = abstract_train_state(model, opt)
    state_sh = train_state_shardings(abstract, mesh)
    batch_sh = _batch_shardings(batch_sds, mesh)
    inner = make_train_step(model, opt)

    def step(state: TrainState, batch: dict):
        state, batch = place(state, state_sh), place(batch, batch_sh)
        with implicit_replication():
            state, metrics = inner(state, batch)
        state = place(state, state_sh)
        metrics = {k: v.redistribute(mesh, _replicated(mesh)) for k, v in metrics.items()}
        return state, metrics

    return step, abstract, state_sh, batch_sh


def _abstract_params(model: Model):
    return dataclasses.replace(model, device=torch.device("meta")).init(torch.Generator())


def jit_prefill_step(model: Model, mesh, batch_sds: dict):
    """Returns (step, abstract_params, param_shardings, batch_shardings).
    ``step(params, batch, cache_len=None)`` gives (logits, caches), the
    caches at the cache rules' placements."""
    batch_sh = _batch_shardings(batch_sds, mesh)
    abstract_params = _abstract_params(model)
    p_sh = param_shardings(abstract_params, mesh)

    def prefill(params, batch, cache_len: int | None = None):
        params, batch = place(params, p_sh), place(batch, batch_sh)
        with implicit_replication():
            logits, caches = model.prefill(params, batch, cache_len)
        return logits, place(caches, cache_shardings(caches, mesh))

    return prefill, abstract_params, p_sh, batch_sh


def jit_decode_step(model: Model, mesh, batch_sds: dict, cache_sds):
    """Returns (step, abstract_params, param_shardings, cache_shardings,
    batch_shardings). ``step(params, caches, batch)`` gives (logits,
    caches), the caches at ``cache_shardings``."""
    batch_sh = _batch_shardings(batch_sds, mesh)
    abstract_params = _abstract_params(model)
    p_sh = param_shardings(abstract_params, mesh)
    c_sh = cache_shardings(cache_sds, mesh)

    def decode(params, caches, batch):
        params, batch = place(params, p_sh), place(batch, batch_sh)
        caches = place(caches, c_sh)
        with implicit_replication():
            logits, caches = model.decode_step(params, caches, batch)
        return logits, place(caches, c_sh)

    return decode, abstract_params, p_sh, c_sh, batch_sh
