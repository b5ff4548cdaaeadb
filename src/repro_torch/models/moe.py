"""Mixture-of-Experts MLP: top-k token-choice routing, grouped SwiGLU
products per expert, optional shared experts (DeepSeek style).

The port of the local path of ``repro/models/moe.py``: every expert on one
card, capacity ``T * top_k``, so no assignment is dropped. The routing is
the reference's (float32 router logits, softmax, top-k, renormalised
weights, the switch-style load-balance loss). The (token, expert)
assignments are sorted stably by expert, each expert's rows go through its
SwiGLU as plain matrix products (the reference's ``ragged_dot``, which XLA
computes outside any Pallas kernel), and the rows come back by the inverse
permutation as (T, k, d) and are summed over k. That combine is
deterministic, where a scatter-add (``index_add_``) would sum in the order
the card's atomics land.

Splitting the sorted rows by expert needs the group sizes on the host: one
device-to-host read per MoE layer call (per shard on a mesh), counted in
``_expert_compute.host_syncs`` when the sizes live on the card. Fake tensors
(the dry-run's ``FakeTensorMode``) have no values to read, so there the
rows take a static-shape path instead (``_expert_compute_static``: every
local expert over all ``cap`` rows, each row keeping its own expert's
output), the dense form ``ragged_dot`` takes on the reference's CPU; the
dry-run, which counts what a card would run, swaps it for a grouped
product over evenly dealt rows (``launch/dryrun.py::_experts_even``).

Expert parallelism (an :class:`EPSpec`) runs the reference's two
``shard_map`` islands through DTensor's ``local_map``, with the same in and
out placements and the collectives on the mesh's sub-groups:

* experts sharded over the ``ep`` axis, each expert's ff dim over the FSDP
  axes; activations sharded over the DP axes and replicated over ``ep``,
  so no token all-to-all: each shard computes its local experts'
  contribution and a sum over ``ep`` combines them;
* the tiny path (decode-scale token counts): weights stay resident, the
  tokens are all-gathered over the FSDP axes, each shard computes its
  (experts, ff) slice for all of them, and the sum over ep x FSDP comes
  back as each shard's own rows (a sum over ``ep``, then a reduce-scatter
  over the FSDP axes: the reference's psum and slice);
* the ZeRO path: each local expert's ff slices are all-gathered over the
  FSDP axes just in time, then one sum over ``ep``.

Gradients are the true ones. An all-gather's backward is a reduce-scatter
of sums and the reverse; the sum over ``ep`` is replicated, so its
backward is the identity; the router's gradient comes out partial over
every mesh axis, the tokens' over ``ep``, and the shared expert's over the
DP axes, and ``local_map`` hands them back so (``in_grad_placements``).
``aux`` is the mean over DP and ``ep`` of each shard's own term, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake

from .config import ModelConfig, MoEConfig
from .layers import _init, mlp_apply, mlp_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EPSpec:
    """How the MoE island maps onto the mesh (None => local path)."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    ep_axis: str = "model"
    fsdp_axes: tuple[str, ...] = ("data",)
    dp_axes: tuple[str, ...] = ("pod", "data")


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """The router is float32 whatever ``dtype`` is, as in the reference."""
    mc = cfg.moe
    d, e, ff = cfg.d_model, mc.n_experts, mc.d_ff_expert
    p = {
        "router": _init(gen, (d, e), d, torch.float32, device),
        "w_gate": _init(gen, (e, d, ff), d, dtype, device),
        "w_up": _init(gen, (e, d, ff), d, dtype, device),
        "w_down": _init(gen, (e, ff, d), ff, dtype, device),
    }
    if mc.n_shared:
        p["shared"] = mlp_init(gen, d, ff * mc.n_shared, dtype, device)
    return p


def _route(x2d: Tensor, router: Tensor, mc: MoEConfig) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k routing. Returns (weights (T,k), experts (T,k), aux loss)."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    weights, experts = torch.topk(probs, mc.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    # switch-style load-balance loss
    e = router.shape[1]
    chosen = torch.zeros_like(probs).scatter_(1, experts, 1.0)
    aux = mc.router_aux_weight * e * torch.sum(chosen.mean(0) * probs.mean(0))
    return weights.to(x2d.dtype), experts, aux


def _expert_compute(x_sorted: Tensor, group_sizes: Tensor, w_gate: Tensor, w_up: Tensor,
                    w_down: Tensor) -> Tensor:
    """Grouped SwiGLU over the sorted rows (cap, d) -> (cap, d): rows of
    group e through expert e, rows past the last group zero (as
    ``ragged_dot`` leaves them)."""
    if group_sizes.is_cuda:
        _expert_compute.host_syncs += 1
    sizes = group_sizes.tolist()
    rest = x_sorted.shape[0] - sum(sizes)
    gates, ups, downs = torch.unbind(w_gate), torch.unbind(w_up), torch.unbind(w_down)
    out = []
    for e, rows in enumerate(torch.split(x_sorted, sizes + [rest])):
        if e == len(sizes):
            out.append(torch.zeros_like(rows))
        elif rows.shape[0]:
            out.append((F.silu(rows @ gates[e]) * (rows @ ups[e])) @ downs[e])
    return torch.cat(out)


_expert_compute.host_syncs = 0


def _expert_compute_static(x_sorted: Tensor, e_sorted: Tensor, w_gate: Tensor, w_up: Tensor,
                           w_down: Tensor) -> Tensor:
    """:func:`_expert_compute` with no data-dependent shape: every local
    expert runs over all ``cap`` rows and row r keeps the output of expert
    ``e_sorted[r]`` (zero for ids past the local experts). E_local times
    the products of the grouped path, for shapes only (fake tensors)."""
    out = torch.zeros_like(x_sorted)
    for e in range(w_gate.shape[0]):
        y = (F.silu(x_sorted @ w_gate[e]) * (x_sorted @ w_up[e])) @ w_down[e]
        out = torch.where((e_sorted == e)[:, None], y, out)
    return out


def _dispatch_compute(
    x2d: Tensor,
    weights: Tensor,
    experts: Tensor,
    n_local_experts: int,
    expert_offset: int,
    cap: int,
    w_gate: Tensor,
    w_up: Tensor,
    w_down: Tensor,
) -> Tensor:
    """Sort the (token, expert) assignments for the local experts, run the
    grouped products over a ``cap``-row buffer, and combine back.
    Assignments to other experts (or beyond capacity) contribute zero."""
    t, k = experts.shape
    flat_e = experts.reshape(-1) - int(expert_offset)  # (T*k,) local expert ids
    flat_w = weights.reshape(-1)
    flat_t = torch.arange(t * k, device=x2d.device) // k
    valid = (flat_e >= 0) & (flat_e < n_local_experts)
    sort_key = torch.where(valid, flat_e, n_local_experts)  # other experts last
    order = torch.argsort(sort_key, stable=True)[:cap]
    e_sorted = sort_key[order]
    w_sorted = torch.where(e_sorted < n_local_experts, flat_w[order], 0.0)
    x_sorted = x2d[flat_t[order]]  # (cap, d)
    if is_fake(e_sorted):  # no values: the group sizes cannot be read
        y_sorted = _expert_compute_static(x_sorted, e_sorted, w_gate, w_up, w_down)
    else:
        group_sizes = torch.bincount(e_sorted, minlength=n_local_experts + 1)[:n_local_experts]
        y_sorted = _expert_compute(x_sorted, group_sizes, w_gate, w_up, w_down)
    y_sorted = y_sorted * w_sorted[:, None].to(y_sorted.dtype)
    # unsort by the inverse permutation to (T, k, d) and sum over k
    y = y_sorted.new_zeros((t * k, x2d.shape[1])).index_put((order,), y_sorted)
    return y.reshape(t, k, -1).sum(1)


def _group(mesh, axes: tuple[str, ...]):
    """The process group over mesh ``axes`` (several: the flattened
    sub-mesh, whose ranks run row-major over the axes, as JAX orders them)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose output is used replicated: its
    backward is the identity (the cotangent is already the same on every
    rank of the group)."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def _psum(x: Tensor, mesh, axes: tuple[str, ...]) -> Tensor:
    for a in axes:
        x = _SumReplicated.apply(x, mesh.get_group(a))
    return x


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over ``group``; backward: the
    reduce-scatter of sums."""

    @staticmethod
    def forward(ctx, x: Tensor, dim: int, group) -> Tensor:
        ctx.dim, ctx.group = dim, group
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],) + xt.shape[1:])
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``group``, each rank keeping its slice of ``dim``; backward:
    the all-gather."""

    @staticmethod
    def forward(ctx, x: Tensor, dim: int, group) -> Tensor:
        ctx.dim, ctx.group = dim, group
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // dist.get_world_size(group),) + xt.shape[1:])
        dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _AllGather.apply(g, ctx.dim, ctx.group), None, None


def _all_gather(x: Tensor, mesh, axes: tuple[str, ...], dim: int) -> Tensor:
    return _AllGather.apply(x, dim, _group(mesh, axes))


def _reduce_scatter(x: Tensor, mesh, axes: tuple[str, ...], dim: int) -> Tensor:
    return _ReduceScatter.apply(x, dim, _group(mesh, axes))


def _mesh_placements(mesh, shard: dict, partial: tuple[str, ...] = ()) -> tuple:
    """One placement per mesh dim: ``Shard(shard[axis])``, ``Partial()`` for
    an axis in ``partial``, else ``Replicate()``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Shard(shard[a]) if a in shard else Partial() if a in partial else Replicate()
                 for a in mesh.mesh_dim_names)


def _moe_ep(p: Params, x: Tensor, cfg: ModelConfig, ep: EPSpec) -> tuple[Tensor, Tensor]:
    """The expert-parallel island over ``ep.mesh``: x (B,S,d) -> (y, aux).
    As in the reference, x's rows (B*S, d) are sharded over the DP axes, so
    a batch narrower than the DP axes is fine when its rows divide them;
    ``t_local`` and ``cap`` keep the reference's arithmetic, which counts
    ``max(B // dp, 1) * S`` rows a rank whatever it holds."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mc = cfg.moe
    mesh = ep.mesh
    b, s, d = x.shape
    size = lambda a: mesh.size(mesh.mesh_dim_names.index(a))
    ep_size = size(ep.ep_axis)
    n_local = mc.n_experts // ep_size
    # per-shard capacity for its local experts' assignments
    dp = math.prod(size(a) for a in ep.dp_axes if a in mesh.mesh_dim_names)
    t_local = max(b // dp, 1) * s
    tiny = t_local * mc.top_k <= 4096
    if tiny:
        cap = t_local * mc.top_k  # tiny buffers (decode): never drop
    else:
        cap = int(t_local * mc.top_k / ep_size * mc.capacity_factor) + 1
        cap = min(cap, t_local * mc.top_k)
    fsdp, dpx, ea = ep.fsdp_axes, ep.dp_axes, ep.ep_axis
    offset = mesh.get_local_rank(ea) * n_local
    tiny = tiny and len(fsdp) > 0

    def island(x2d_l, router, w_gate_l, w_up_l, w_down_l, *shared_l):
        if tiny:
            # weights stay resident; the tokens come to them over the FSDP
            # axes, and each rank's (experts, ff) slice gives a partial sum
            x_all = _all_gather(x2d_l, mesh, fsdp, 0)  # (T_all, d)
            weights, experts, aux = _route(x_all, router, mc)
            y = _dispatch_compute(x_all, weights, experts, n_local, offset,
                                  x_all.shape[0] * mc.top_k, w_gate_l, w_up_l, w_down_l)
            y = _reduce_scatter(_psum(y, mesh, (ea,)), mesh, fsdp, 0)  # own rows
        else:
            # ZeRO-3: gather the local experts' ff slices just in time
            w_gate = _all_gather(w_gate_l, mesh, fsdp, 2)
            w_up = _all_gather(w_up_l, mesh, fsdp, 2)
            w_down = _all_gather(w_down_l, mesh, fsdp, 1)
            weights, experts, aux = _route(x2d_l, router, mc)
            y = _dispatch_compute(x2d_l, weights, experts, n_local, offset, cap,
                                  w_gate, w_up, w_down)
        if shared_l:
            # shared slices are ff-sharded over ep only (FSDP-replicated);
            # the rank's own rows are the reference's slice of x_all's
            sh = mlp_apply(dict(zip(("w_gate", "w_up", "w_down"), shared_l)), x2d_l)
            y = y + _psum(sh, mesh, (ea,)) if tiny else y + sh
        if not tiny:
            y = _psum(y, mesh, (ea,))
        axes = tuple(a for a in dpx + (ea,) if a in mesh.mesh_dim_names)
        aux = _psum(aux, mesh, axes) / math.prod(size(a) for a in axes)
        return y, aux

    dp_in = {a: 0 for a in dpx if a in mesh.mesh_dim_names}
    w_in = dict({a: 2 for a in fsdp}, **{ea: 0})
    wd_in = dict({a: 1 for a in fsdp}, **{ea: 0})
    in_pl = [_mesh_placements(mesh, dp_in), _mesh_placements(mesh, {}),
             _mesh_placements(mesh, w_in), _mesh_placements(mesh, w_in),
             _mesh_placements(mesh, wd_in)]
    grad_pl = [_mesh_placements(mesh, dp_in, (ea,)),
               _mesh_placements(mesh, {}, tuple(mesh.mesh_dim_names))] + in_pl[2:]
    # A batch narrower than the DP axes splits over them by rows, not by
    # sequences, and DTensor's views can neither unflatten rows split
    # unevenly into sequences nor flatten a batch of one split over axes of
    # size 1: such a batch is whole on every rank around the island (as the
    # sharding rules place it), its rows split inside.
    whole = isinstance(x, DTensor) and (b % dp != 0 or b == 1)
    if whole:
        x = x.redistribute(mesh, [Replicate() if pl == Shard(0) else pl for pl in x.placements])
    args = [x.reshape(b * s, d), p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    if mc.n_shared:
        sh = p["shared"]
        args += [sh["w_gate"], sh["w_up"], sh["w_down"]]
        for spec in ({ea: 1}, {ea: 1}, {ea: 0}):
            in_pl.append(_mesh_placements(mesh, spec))
            grad_pl.append(_mesh_placements(mesh, spec, tuple(dp_in)))
    y2d, aux = local_map(
        island,
        out_placements=(_mesh_placements(mesh, dp_in), _mesh_placements(mesh, {})),
        in_placements=tuple(in_pl),
        in_grad_placements=tuple(grad_pl),
        device_mesh=mesh,
        redistribute_inputs=True,
    )(*args)
    if whole:
        y2d = y2d.redistribute(mesh, [Replicate()] * mesh.ndim)
    return y2d.reshape(b, s, d), aux


def moe_apply(p: Params, x: Tensor, cfg: ModelConfig, ep: EPSpec | None = None) -> tuple[Tensor, Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss scalar): the local path, or the
    expert-parallel island under ``ep``."""
    if ep is not None:
        return _moe_ep(p, x, cfg, ep)
    mc = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts, aux = _route(x2d, p["router"], mc)
    y = _dispatch_compute(
        x2d, weights, experts, mc.n_experts, 0, b * s * mc.top_k,  # no dropping
        p["w_gate"], p["w_up"], p["w_down"],
    )
    if mc.n_shared:
        y = y + mlp_apply(p["shared"], x2d)
    return y.reshape(b, s, d), aux
