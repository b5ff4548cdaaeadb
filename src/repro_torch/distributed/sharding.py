"""Sharding rules: logical axes -> mesh axes, divisibility-aware.

The port of ``repro/distributed/sharding.py``. Parallelism scheme:
  * batch/DP     -> ('pod', 'data')   (or ('data',) on a single pod)
  * TP ("tp")    -> 'model'           heads / d_ff / vocab / experts
  * FSDP ("fsdp")-> DP axes           the non-TP dim of every large param
  * EP           -> 'model'           MoE experts (the ``models/moe.py`` island)
  * SP           -> DP axes           long-context decode KV cache seq dim

Every rule is *divisibility-aware*: if a dim does not divide by the mesh
axes assigned to it, those axes are dropped (replicated), trailing axes
first -- e.g. smollm-135m's 9 heads cannot split 16-way TP, so its
attention is replicated while its MLP/vocab still shard.

The rules read only axis names and sizes, so they take a torch
``DeviceMesh`` or a :class:`MeshShape` (names and sizes, no ranks: the
production meshes). A spec is a :class:`P`, one entry per dimension (None,
an axis name or a tuple of names) with trailing Nones trimmed, as JAX's
``PartitionSpec`` holds them; :func:`placements` turns it into DTensor
placements. Leaves are named by their key strings, as
``repro_torch.tree.flatten_with_keys`` gives them (``['stack']['period'][0]
['attn']['wq']``), which are the reference's ``keystr`` names.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.tree import flatten_with_keys, unflatten_like

# leaf-name -> logical spec (one entry per trailing dim; leading stacked
# period dims are padded with None automatically)
_RULES: dict[str, tuple[str | None, ...]] = {
    # embeddings / head
    "embed": ("tp", "fsdp"),  # (vocab, d)
    "lm_head": ("fsdp", "tp"),  # (d, vocab)
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # MLA
    "wq_a": ("fsdp", None),
    "wq_b": (None, "tp"),
    "wkv_a": ("fsdp", None),
    "w_uk": (None, "tp"),
    "w_uv": (None, "tp"),
    # dense mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (expert-stacked; name collision with dense mlp resolved by rank)
    "router": (None, None),
    # rglru
    "w_y": ("fsdp", "tp"),
    "w_x": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "w_i": (None, "tp"),
    "w_a": (None, "tp"),
    "lam": ("tp",),
    "w_out": ("tp", "fsdp"),
    # rwkv
    "w_r": ("fsdp", "tp"),
    "w_k": ("fsdp", "tp"),
    "w_v": ("fsdp", "tp"),
    "w_g": ("fsdp", "tp"),
    "w_o": ("tp", "fsdp"),
    "decay_w0": (None,),
    "decay_a": ("fsdp", None),
    "decay_b": (None, "tp"),
    "bonus_u": (None, None),
    "ln_scale": (None, None),
    "mix": (None, None),
    "cm_mix": (None, None),
    "cm_k": ("fsdp", "tp"),
    "cm_v": ("tp", "fsdp"),
    "cm_r": ("fsdp", "tp"),
    # norms / scalars
    "scale": (None,),
    "ln_tm": (None,),
    "ln_cm": (None,),
}

# MoE expert tensors are rank-3 (E, d, ff) and must match moe.EPSpec:
_MOE_RULES = {
    "w_gate": ("tp", None, "fsdp"),  # experts over model, ff over fsdp
    "w_up": ("tp", None, "fsdp"),
    "w_down": ("tp", "fsdp", None),
}
_MOE_SHARED_RULES = {
    "w_gate": (None, "tp"),
    "w_up": (None, "tp"),
    "w_down": ("tp", None),
}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without ranks (the production meshes,
    which the rules can read with no process group)."""

    names: tuple[str, ...]
    sizes: tuple[int, ...]


class P(tuple):
    """A partition spec: one entry per dimension, each None, an axis name or
    a tuple of axis names (JAX's ``PartitionSpec`` as a plain tuple; a
    one-name tuple is kept as the name, as JAX keeps it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return tuple(mesh.names)
    return tuple(mesh.mesh_dim_names)


def _axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, MeshShape):
        return int(mesh.sizes[mesh.names.index(axis)])
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def mesh_axes(mesh) -> dict[str, tuple[str, ...]]:
    names = _axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    return {"tp": ("model",) if "model" in names else (), "fsdp": dp, "dp": dp}


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(_axis_size(mesh, a) for a in axes) if axes else 1


def _resolve(logical: str | None, dim: int, mesh) -> Any:
    if logical is None:
        return None
    axes = mesh_axes(mesh).get(logical, ())
    # greedily drop trailing axes until divisible (e.g. 9 heads vs 16-way tp)
    while axes and dim % _axes_size(mesh, axes) != 0:
        axes = axes[:-1]
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]|\.(\w+)")


def path_names(path: str) -> list:
    """The names along a leaf's key string, as the reference reads them off
    its path: a dict key as its string, a list or tuple index as its int, a
    NamedTuple field as None (JAX's ``GetAttrKey`` has no ``key``)."""
    out = []
    for key, idx, attr in _KEY.findall(path):
        out.append(key if idx == "" and attr == "" else int(idx) if idx else None)
    return out


def _leaf_name(names: list) -> str | None:
    return next((n for n in reversed(names) if isinstance(n, str)), None)


def spec_for_leaf(path, leaf, mesh) -> P:
    """The partition spec of one parameter leaf, from its key name."""
    names = path_names(path)
    name = _leaf_name(names)
    shape = leaf.shape
    in_moe = "moe" in names
    in_shared = in_moe and "shared" in names
    if in_shared and name in _MOE_SHARED_RULES:
        rule = _MOE_SHARED_RULES[name]
    elif in_moe and name in _MOE_RULES and len(shape) >= 3:
        rule = _MOE_RULES[name]
    else:
        rule = _RULES.get(name)
    if rule is None:
        return P()  # replicate unknown leaves
    # pad for leading stacked dims (period stacking)
    rule = (None,) * (len(shape) - len(rule)) + tuple(rule)
    entries = [_resolve(r, int(shape[i]), mesh) for i, r in enumerate(rule)]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def placements(spec: P, mesh) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(d)`` where the
    spec splits tensor dim d over that mesh axis, else ``Replicate()``.

    A dim split over several axes (``("pod", "data")``) gets ``Shard(d)`` on
    each of them. DTensor splits such a dim with the earlier mesh dimension
    as the major index, which is JAX's major-to-minor reading of the tuple
    only when the tuple lists its axes in mesh order, so any other order
    raises."""
    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); a leaf of a shardings
    tree."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _tree_specs(tree, mesh, rule) -> Any:
    return unflatten_like(tree, {key: NamedSharding(mesh, rule(key, leaf, mesh))
                                 for key, leaf in flatten_with_keys(tree)})


def param_shardings(abstract_params, mesh):
    """A tree of :class:`NamedSharding`s for a (possibly ``meta``)
    parameter tree."""
    return _tree_specs(abstract_params, mesh, spec_for_leaf)


# ------------------------------------------------------------------ batches
def batch_specs(batch_shapes: dict, mesh) -> dict:
    """The spec of each batch entry: the batch dim over the DP axes when it
    divides, else the sequence dim (long-context decode)."""
    dp = mesh_axes(mesh)["dp"]
    dp_n = _axes_size(mesh, dp)
    out = {}
    for k, v in batch_shapes.items():
        shape = v.shape
        if k == "positions" and len(shape) == 3:  # (3, B, S)
            out[k] = P(None, dp if shape[1] % dp_n == 0 else None, None)
            continue
        if not shape:
            out[k] = P()
            continue
        if shape[0] % dp_n == 0 and dp:
            out[k] = P(dp, *(None,) * (len(shape) - 1))
        elif len(shape) >= 2 and shape[1] % dp_n == 0 and dp:
            out[k] = P(None, dp, *(None,) * (len(shape) - 2))
        else:
            out[k] = P(*(None,) * len(shape))
    return out


_CACHE_LEAVES = ("k", "v", "ckv", "kpe", "state", "h", "conv", "shift_tm", "shift_cm")


def cache_spec_for_leaf(path, leaf, mesh) -> P:
    """A decode / prefill cache's spec: batch over DP if divisible, else the
    sequence dim over DP (sequence parallelism for long-context caches);
    the kv-head dim over TP when divisible."""
    names = path_names(path)
    name = _leaf_name(names)
    shape = leaf.shape
    dp = mesh_axes(mesh)["dp"]
    tp = mesh_axes(mesh)["tp"]
    dp_n = _axes_size(mesh, dp)
    # caches may carry a leading (n_periods,) stacked dim: detect by name
    lead = 1 if len(shape) >= 1 and name in _CACHE_LEAVES and _looks_stacked(names) else 0
    entries: list[Any] = [None] * len(shape)
    b_ax, s_ax = lead, lead + 1
    if len(shape) > b_ax and shape[b_ax] % dp_n == 0 and dp:
        entries[b_ax] = dp if len(dp) > 1 else dp[0]
    elif name in ("k", "v", "ckv", "kpe") and len(shape) > s_ax and shape[s_ax] % dp_n == 0 and dp:
        entries[s_ax] = dp if len(dp) > 1 else dp[0]
    if name in ("k", "v") and len(shape) >= s_ax + 3:
        kh = int(shape[s_ax + 1])
        if tp and kh % _axes_size(mesh, tp) == 0:
            entries[s_ax + 1] = tp[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _looks_stacked(names: list) -> bool:
    # period caches sit under a tuple index inside {"period": (...)}
    return "period" in names


def cache_shardings(abstract_caches, mesh):
    """A tree of :class:`NamedSharding`s for a cache tree."""
    return _tree_specs(abstract_caches, mesh, cache_spec_for_leaf)


@register_sharding(torch.ops.aten.log_sigmoid_backward.default)
def _log_sigmoid_backward_sharding(grad_output, x, buffer):
    """DTensor has no strategy for the backward of ``F.logsigmoid`` (RG-LRU's
    gate on ``lam``): it is pointwise, so any placement that all three
    operands share."""
    out = [([Replicate()], [Replicate()] * 3)]
    for d in range(x.ndim):
        out.append(([Shard(d)], [Shard(d)] * 3))
    return out
