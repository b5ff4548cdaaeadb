"""Functions run on each rank's (batch, head) block of DTensors.

Some computations are independent per batch row and per head: attention's
core, RWKV6's recurrence, the MLP's columns of ff. Run by DTensor's
sharding propagation op by op, their batched products merge a DP-sharded
batch dim with a TP-sharded head dim into strided shards, whose
redistributions DTensor plans by a graph search on every new shape (on
the (pod, data, model) mesh a single product of the MLP took minutes), and
a per-token loop pays DTensor's host cost on every step. ``local_blocks``
runs such a function once per rank on local tensors through ``local_map``:
the batch dim over the DP axes when it divides them, the head dim over
``model`` when every head count divides it, each replicated otherwise.

An axis that splits the work but not a tensor leaves that tensor's
per-rank value a share of a sum: a gradient of a weight without a batch
dim, over the DP axes, an activation's gradient without a head dim, over
``model``, and an output without a head dim, over ``model`` (the MLP's
down-projection sums over its ff slice). All come back ``Partial`` there.
The output stays a partial sum rather than being reduced inside the
block, so the block holds no collective of its own to differentiate; the
caller sums it where the reference's semantics need the sum, at the
residual add (``placed_like``), and sums the input's gradient in the
backward (``grad_placed``). Left to DTensor, a partial residual is what
it makes of either at no cost, and the next norm reduce-scatters it over
the sequence, so that every product after it merges a strided shard.
Every other placement is the input's, or ``Shard`` / ``Replicate`` for an
output.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def local_blocks(fn: Callable, args: Sequence[Tensor], dims: Sequence[tuple],
                 out_dims: Sequence[tuple]):
    """``fn(*args)`` on each rank's block. ``dims[i]`` is arg i's (batch
    dim, head dim), either None; ``out_dims`` likewise for each output (a
    single output: one entry; one without a head dim is a partial sum over
    ``model`` when the heads are split). A plain tensor arg is taken as
    replicated (every rank holds the same value). Returns DTensors, a
    tuple for several outputs."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_n = math.prod(mesh.size(names.index(a)) for a in dp)
    tp_n = mesh.size(names.index("model")) if "model" in names else 0
    batch = all(a.shape[b] % dp_n == 0 for a, (b, _) in zip(args, dims) if b is not None)
    heads = tp_n > 0 and any(h is not None for _, h in dims) and all(
        a.shape[h] % tp_n == 0 for a, (_, h) in zip(args, dims) if h is not None)

    def pl(b, h, split=Replicate):
        """Placements for (batch dim, head dim); ``split`` where the work
        is split over an axis that the tensor has no dim for."""
        out = []
        for a in names:
            if a in dp and batch:
                out.append(Shard(b) if b is not None else split())
            elif a == "model" and heads:
                out.append(Shard(h) if h is not None else split())
            else:
                out.append(Replicate())
        return tuple(out)

    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * len(names), run_check=False)
            for a in args]
    in_pl = tuple(pl(*d) for d in dims)
    grad_pl = tuple(pl(*d, split=Partial) for d in dims)
    out_pl = [list(pl(*d, split=Partial)) for d in out_dims]
    return local_map(fn, out_placements=out_pl[0] if len(out_pl) == 1 else tuple(out_pl),
                     in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def placed_like(y: Tensor, x: Tensor) -> Tensor:
    """y redistributed to x's placements when both are DTensors (partial
    sums summed, shards gathered), else y as it is: what a residual add
    ``x + placed_like(y, x)`` needs to keep the stream's placements."""
    if isinstance(y, DTensor) and isinstance(x, DTensor):
        y = _placed(y, x.placements)
    return y


def _placed(y: DTensor, placements) -> DTensor:
    """y at ``placements``, a partial sum among them taken whole (a value
    cannot be made partial, and a sum is what a partial stands for)."""
    placements = tuple(Replicate() if pl.is_partial() else pl for pl in placements)
    return y if tuple(y.placements) == placements else y.redistribute(y.device_mesh, placements)


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward hands on its gradient at the forward
    input's placements (kept, not the input: the input stays free for a
    checkpoint to drop)."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _placed(g, ctx.placements) if isinstance(g, DTensor) else g


def grad_placed(x: Tensor) -> Tensor:
    """x, whose gradient comes back at x's own placements: the input of
    products whose gradients DTensor leaves partial over ``model`` or
    split on d (``local_blocks`` returns an input's gradient partial over
    an axis that splits the work but not that input)."""
    return _GradPlaced.apply(x) if isinstance(x, DTensor) else x


def rows_product(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` for a weight that splits no dim over ``model`` (MLA's and
    RWKV6's low-rank down-projections): on a mesh each rank multiplies its
    batch rows, the product whole on every rank of ``model``. Left to
    DTensor, the product may come out split over ``model`` on its columns
    (a free slice of a replicated weight), and its next norm or product
    then reduce-scatters it over the sequence."""
    if isinstance(x, DTensor):
        return local_blocks(torch.matmul, (x, w), [(0, None), (None, None)], [(0, None)])
    return x @ w


def split_last(x: Tensor, *sizes: int) -> Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)``. A DTensor whose last dim is
    split over mesh axes that do not divide ``sizes[0]`` (9 heads over a
    model axis of 2: the product's columns divide, the heads do not) is
    first replicated over those axes, as GSPMD would gather it: DTensor's
    view cannot split a sharded dim unevenly."""
    return _unsplit_last(x, sizes[0]).reshape(*x.shape[:-1], *sizes)


def _unsplit_last(x: Tensor, n: int) -> Tensor:
    """A DTensor whose last dim is split over mesh axes that do not divide
    ``n``, replicated over those axes; anything else as it is."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        on = [i for i, pl in enumerate(x.placements)
              if isinstance(pl, Shard) and pl.dim in (last, -1)]
        if on and n % math.prod(x.device_mesh.size(i) for i in on):
            x = x.redistribute(x.device_mesh, [Replicate() if i in on else pl
                                               for i, pl in enumerate(x.placements)])
    return x


class _MergedLast(torch.autograd.Function):
    """The identity, whose backward hands on a gradient that
    ``merge_last``'s reshape can split back into its ``n`` parts."""

    @staticmethod
    def forward(ctx, x: Tensor, n: int) -> Tensor:
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _unsplit_last(g, ctx.n), None


def merge_last(x: Tensor) -> Tensor:
    """``x.reshape(*x.shape[:-2], -1)``, (..., n, w) to (..., n * w). Its
    gradient comes back through the reshape's backward, a split into n
    parts, which DTensor cannot make of a dim split over axes that do not
    divide n (9 heads on a model axis of 16, when DTensor has left the
    gradient sharded on d): such a gradient is first replicated over them,
    as ``split_last`` does in the forward."""
    n = x.shape[-2]
    return _MergedLast.apply(x.reshape(*x.shape[:-2], -1), n)
