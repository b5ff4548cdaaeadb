"""Roofline terms of a step on the H100, from a count of the ops it
dispatches.

The port of ``repro/launch/roofline.py`` on the card's own terms. The
reference reads XLA's ``cost_analysis`` of an SPMD program, which is per
device; the port compiles no program, so :class:`CostCounter`, a
``TorchDispatchMode``, counts the aten ops a step dispatches and gives a
:class:`CellCosts`. The three terms are per card:

  compute    = FLOPs(per device) / peak for the cell's dtype
  memory     = fused bytes(per device) / HBM rate
  collective = sum over mesh axes of bytes(axis) / link rate(axis)

and model-FLOPs comparisons divide the global 6ND by the card count.

Constants: NVIDIA's H100 Tensor Core GPU datasheet, H100 SXM5 80 GB at 700
W (dense figures, half the datasheet's "with sparsity" ones): bfloat16
989.4 TFLOP/s, TF32 494.7, FP32 (CUDA cores) 66.9; HBM3 3.35 TB/s; NVLink 4
900 GB/s a GPU, 450 GB/s a direction. Across nodes, NDR InfiniBand at 400
Gb/s = 50 GB/s a GPU (a DGX H100 has one NIC a GPU). The compute peak is
picked by the cell's dtype; the dry-run's cells are bfloat16.

Links. Ranks are laid out row-major, the last mesh axis innermost, 8 to a
node. An axis whose every group lies inside one node moves at NVLink's
rate; any other axis at InfiniBand's. On the production meshes, (16, 16)
and (2, 16, 16) with ``model`` innermost, the 16-wide ``model`` axis spans
two nodes, so every axis there is an InfiniBand axis; on a (4, 2) mesh
both axes stay inside a node.

Per device. Above DTensor a dispatch mode sees an op on global shapes. The
counter lets DTensor handle every op on DTensors and counts the ops it then
runs on the local shards, the collectives of its redistributions included:
a product on a replicated operand counts in full on every rank, one
sharded n ways 1/n. The process counts its own rank's shards (rank 0 in
the dry-run). DTensor's bookkeeping is not counted: the ops it runs on
global shapes only to propagate shapes and strides, the index arithmetic
of a strided shard's local size and the decompositions it runs to find a
strategy for an op that has none (both run on real tensors, since under
``FakeTensorMode`` they would need values).

What is counted:

* FLOPs of the products (mm, bmm, addmm, baddbmm, convolution, SDPA), by
  ``torch.utils.flop_counter``'s formulas;
* ``fused_bytes``, the reference's split of what crosses HBM under full
  fusion: products count their operands and their output; gather,
  scatter and index ops, cat, pad, copies, sort and reductions their
  output only; pure elementwise ops, views and fills nothing (they fuse
  into their producers and consumers);
* ``bytes_accessed``: every op's inputs and outputs, views excepted (the
  pre-fusion upper bound);
* collective payloads (the larger of input and output) of the
  ``_c10d_functional`` ops DTensor issues and the ``c10d`` ops
  ``torch.distributed``'s calls issue, by process group, mapped to mesh
  axes through ``mesh.get_group(axis).group_name``;
* peak live bytes: each new storage an op returns is live from then until
  its last tensor dies (a weak reference on the storage), the port's own
  count rather than ``torch.distributed._tools``, which is private.

Loop correction. The reference counts a scanned period once and
extrapolates (:func:`extrapolate`); the port executes every layer, so the
count at full depth is the count. RWKV6's token loop is the exception: the
dry-run runs a stand-in for it and adds its FLOPs and bytes analytically
(:func:`rwkv_counter_misses`, :func:`wkv_io_bytes`; the reference's
:func:`rwkv_inner_correction` is the same count, sharded over batch
only).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989.4e12  # dense bfloat16 / card
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989.4e12,
    "float16": 989.4e12,
    "tf32": 494.7e12,
    "float32": 66.9e12,
}
HBM_BW = 3.35e12  # B/s / card, HBM3
NVLINK_BW = 450e9  # B/s / card / direction, NVLink 4 inside a node
IB_BW = 50e9  # B/s / card, NDR InfiniBand across nodes
NODE_GPUS = 8


def peak_flops(dtype: str) -> float:
    """The card's dense peak for products of ``dtype`` ("bfloat16",
    "float16", "tf32" or "float32")."""
    return PEAK_FLOPS_BY_DTYPE[dtype]


def link_rate(axis: str, intra_node_axes) -> float:
    return NVLINK_BW if axis in tuple(intra_node_axes) else IB_BW


@dataclasses.dataclass
class CellCosts:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    peak_memory_bytes: float = 0.0
    fused_bytes: float = 0.0  # fusion-aware HBM traffic (see above)
    collective_by_axis: dict = dataclasses.field(default_factory=dict)
    intra_node_axes: tuple = ()
    dtype: str = "bfloat16"

    def roofline(self, chips: int) -> dict[str, float]:
        # the counts are per device: no division by ``chips``
        compute = self.flops / peak_flops(self.dtype)
        memory = self.fused_bytes / HBM_BW
        memory_prefusion = self.bytes_accessed / HBM_BW  # upper bound
        coll = sum(b / link_rate(a, self.intra_node_axes)
                   for a, b in self.collective_by_axis.items())
        # bytes on no named axis move at the slower rate
        coll += max(self.collective_bytes - sum(self.collective_by_axis.values()), 0.0) / IB_BW
        dominant = max(
            ("compute", compute), ("memory", memory), ("collective", coll),
            key=lambda kv: kv[1],
        )[0]
        return {
            "compute_s": compute,
            "memory_s": memory,
            "memory_prefusion_s": memory_prefusion,
            "collective_s": coll,
            "dominant": dominant,
            "bound_step_s": max(compute, memory, coll),
        }


def extrapolate(c1: CellCosts, c2: CellCosts, n_periods: int) -> CellCosts:
    """Totals from 1-period and 2-period counts: per_period = c2 - c1;
    total = c1 + (n_periods - 1) * per_period. The port counts every layer,
    so it needs this only to show that its counts are linear in periods."""
    d = lambda a, b: max(b - a, 0.0)
    axes = set(c1.collective_by_axis) | set(c2.collective_by_axis)
    by_axis = {
        a: c1.collective_by_axis.get(a, 0.0) + (n_periods - 1) * d(
            c1.collective_by_axis.get(a, 0.0), c2.collective_by_axis.get(a, 0.0))
        for a in axes
    }
    return CellCosts(
        flops=c1.flops + (n_periods - 1) * d(c1.flops, c2.flops),
        bytes_accessed=c1.bytes_accessed
        + (n_periods - 1) * d(c1.bytes_accessed, c2.bytes_accessed),
        collective_bytes=c1.collective_bytes
        + (n_periods - 1) * d(c1.collective_bytes, c2.collective_bytes),
        peak_memory_bytes=c1.peak_memory_bytes,
        fused_bytes=c1.fused_bytes + (n_periods - 1) * d(c1.fused_bytes, c2.fused_bytes),
        collective_by_axis=by_axis,
        intra_node_axes=c1.intra_node_axes,
        dtype=c1.dtype,
    )


# ------------------------------------------------------------- pure math
def model_flops(cfg, shape, n_active_params: int, total_params: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode counts one
    token per sequence."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    return 2.0 * n_active_params * shape.global_batch  # decode: fwd only


def rwkv_inner_correction(cfg, shape, chips: int) -> float:
    """Analytic PER-DEVICE FLOPs of the WKV time recurrence, as the
    reference counts them: ~8 * tokens * d * head_size a layer, sharded
    over batch (DP) only."""
    if "rwkv" not in cfg.period and "rwkv" not in cfg.prefix:
        return 0.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    per_layer = 8.0 * tokens * cfg.d_model * cfg.rwkv_head_size
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd
    dp = max(chips // 16, 1)  # batch shards over the non-model axes
    return per_layer * cfg.n_layers * mult / dp


def _dp(mesh_shape: dict[str, int]) -> int:
    return math.prod(mesh_shape.get(a, 1) for a in ("pod", "data"))


def _wkv_local(cfg, shape, mesh_shape: dict[str, int]) -> tuple[int, int, int, int]:
    """(rows, tokens, heads, head size) of the WKV recurrence on one rank:
    the port runs it on each rank's (batch, head) block
    (``distributed.blocks.local_blocks``), the batch over the DP axes where
    it divides them, the heads over ``model`` where they divide it."""
    hd = cfg.rwkv_head_size
    h = cfg.d_model // hd
    dp, tp = _dp(mesh_shape), mesh_shape.get("model", 1)
    b = shape.global_batch
    t = shape.seq_len if shape.kind != "decode" else 1
    return (b // dp if b % dp == 0 else b), t, (h // tp if h % tp == 0 else h), hd


def rwkv_counter_misses(cfg, shape, mesh_shape: dict[str, int]) -> float:
    """Per-device FLOPs of the WKV recurrence that a dry-run's count does
    not hold: the reference's 8 hd² a (row, head, token), 24 in training.
    In train and prefill the dry-run runs a stand-in for the token loop
    (``dryrun._wkv_io_only``: a Python loop of thousands of steps a layer
    takes minutes under fake tensors), so all of it; a decode step runs for
    real and the counter sees its one product, r against the state (2
    hd²), not the elementwise outer product, bonus and decay."""
    n_rwkv = sum(1 for k in cfg.layer_kinds if k == "rwkv")
    if not n_rwkv:
        return 0.0
    b, t, h, hd = _wkv_local(cfg, shape, mesh_shape)
    per = 8.0 * (3.0 if shape.kind == "train" else 1.0) - (2.0 if shape.kind == "decode" else 0.0)
    return n_rwkv * b * t * h * hd * hd * per


def wkv_io_bytes(cfg, shape, mesh_shape: dict[str, int]) -> float:
    """Per-device HBM traffic of the WKV recurrence in train and prefill
    as one pass would move it, the state kept on chip: r, k, v (bfloat16)
    and w (float32) read, o (float32) written, the (hd, hd) float32 state
    read and written once, a layer; training ~3x (as ``flash_io_bytes``).
    What the dry-run's stand-in for the loop adds back."""
    n_rwkv = sum(1 for k in cfg.layer_kinds if k == "rwkv")
    if not n_rwkv or shape.kind == "decode":
        return 0.0
    b, t, h, hd = _wkv_local(cfg, shape, mesh_shape)
    per_layer = b * t * h * hd * (3 * 2 + 4 + 4) + 2 * b * h * hd * hd * 4
    return n_rwkv * per_layer * (3.0 if shape.kind == "train" else 1.0)


def flash_io_bytes(cfg, shape, mesh_shape: dict[str, int]) -> float:
    """Per-device HBM traffic of the flash-attention core: exactly q + k + v
    + out per layer (tiles live in on-chip memory). Train multiplies by ~3
    (backward re-reads q/k/v/out and writes dq/dk/dv)."""
    if "rwkv" in cfg.period or shape.kind == "decode":
        return 0.0
    b_loc = max(shape.global_batch // _dp(mesh_shape), 1)
    t = shape.seq_len
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    per_layer = b_loc * t * (2 * h + 2 * kh) * hd * 2  # q+out (H) + k+v (KH), bf16
    n_attn = sum(1 for k in cfg.layer_kinds if k not in ("rglru", "rwkv"))
    mult = 3.0 if shape.kind == "train" else 1.0
    return per_layer * n_attn * mult


def attention_hbm_adjustment(cfg, shape, mesh_shape: dict[str, int]) -> float:
    """Per-device HBM bytes of score / probability tiles that a lax-level
    chunked attention materializes but a flash kernel keeps on chip: ~6 B
    per visible (query, key) pair forward, ~26 B in training."""
    if "rwkv" in cfg.period:  # attention-free
        return 0.0
    b_loc = max(shape.global_batch // _dp(mesh_shape), 1)
    t = shape.seq_len
    if shape.kind == "decode":
        return 0.0  # decode scores are (B,H,1,S): negligible
    h = cfg.n_heads
    pairs = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "dense", "moe") or kind.startswith("mla"):
            pairs += t * t / 2
        elif kind == "local":
            pairs += t * min(cfg.window, t)
        elif kind == "xattn":
            pairs += t * t / 2 + t * cfg.encoder_seq
        elif kind in ("rglru", "rwkv"):
            continue
    if cfg.encoder_layers:
        pairs += cfg.encoder_layers * cfg.encoder_seq**2
    bytes_per_pair = 26.0 if shape.kind == "train" else 6.0
    return b_loc * h * pairs * bytes_per_pair


def moe_cpu_excess(cfg, shape, mesh_shape: dict[str, int]) -> float:
    """Per-device FLOPs that a dense all-experts expert product (the
    reference's ``ragged_dot`` on a CPU) executes BEYOND the true grouped
    product: excess factor (E_local - 1) on the routed expert compute."""
    if cfg.moe is None:
        return 0.0
    mc = cfg.moe
    ep = mesh_shape.get("model", 1)
    dp = _dp(mesh_shape)
    e_local = max(mc.n_experts // ep, 1)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        t_local = max(b // dp, 1)
    else:
        t_local = max(b // dp, 1) * s
    if t_local * mc.top_k <= 4096:
        cap = t_local * mc.top_k
    else:
        cap = min(
            int(t_local * mc.top_k / ep * mc.capacity_factor) + 1,
            t_local * mc.top_k,
        )
    n_moe = sum(1 for k in cfg.layer_kinds if k in ("moe", "mla"))
    per_layer_dense = 3 * 2 * cap * cfg.d_model * mc.d_ff_expert * e_local
    mult = 3.0 if shape.kind == "train" else 1.0
    return n_moe * per_layer_dense * (1.0 - 1.0 / e_local) * mult


# --------------------------------------------------------------- counter
_OUT_ONLY = frozenset({
    "gather", "scatter", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_",
    "index", "_unsafe_index", "index_put", "index_put_", "_index_put_impl_",
    "_unsafe_index_put", "index_select", "index_add", "index_add_", "index_copy",
    "embedding", "embedding_dense_backward", "slice_scatter", "select_scatter",
    "masked_scatter", "cat", "constant_pad_nd", "pad", "copy", "copy_", "clone",
    "repeat", "repeat_interleave", "flip", "roll", "sort", "topk", "bincount",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "cumsum",
    "var", "var_mean", "std", "norm", "linalg_vector_norm", "any", "all", "argmax",
    "argmin",
})
_COLLECTIVES = {  # namespace -> collective ops (``wait_tensor`` re-states a shape)
    "_c10d_functional": frozenset({
        "all_reduce", "all_reduce_", "all_gather_into_tensor", "all_gather_into_tensor_out",
        "reduce_scatter_tensor", "all_to_all_single", "broadcast", "broadcast_",
        "all_reduce_coalesced", "all_gather_into_tensor_coalesced",
        "reduce_scatter_tensor_coalesced",
    }),
    "c10d": frozenset({
        "allreduce_", "allgather_", "_allgather_base_", "reduce_scatter_",
        "_reduce_scatter_base_", "alltoall_", "alltoall_base_", "broadcast_",
        "allreduce_coalesced_", "allgather_into_tensor_coalesced_",
        "reduce_scatter_tensor_coalesced_",
    }),
}
_PG = "__torch__.torch.classes.c10d.ProcessGroup"


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _group_name(func, args, kwargs) -> str:
    """The process group a collective runs on: its ``group_name`` argument
    (``_c10d_functional``) or its boxed ProcessGroup (``c10d``)."""
    schema = func._schema.arguments
    for i, arg in enumerate(schema):
        if arg.name == "group_name":
            return kwargs["group_name"] if "group_name" in kwargs else args[i]
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name() == _PG:
            return torch.distributed.ProcessGroup.unbox(a).group_name
    raise ValueError(f"{func}: a collective without a process group")


def mesh_groups(mesh) -> tuple[dict[str, str], tuple[str, ...]]:
    """``(group name -> axis label, the axes inside one node)`` for a
    DeviceMesh: each axis, and the DP axes flattened where there are
    several (the MoE island's FSDP and DP groups), labelled "pod,data". An
    axis is inside a node when each of its groups' ranks share
    ``rank // NODE_GPUS``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    names = mesh.mesh_dim_names
    with unset_fake_temporarily():
        ranks = np.asarray(mesh.mesh.tolist())  # the global ranks, laid out as the mesh

    def inside(dims: tuple[int, ...]) -> bool:
        rest = [i for i in range(ranks.ndim) if i not in dims]
        groups = ranks.transpose(*rest, *dims).reshape(-1, math.prod(ranks.shape[i] for i in dims))
        nodes = groups // NODE_GPUS
        return bool((nodes == nodes[:, :1]).all())

    labels, intra = {}, []
    for i, a in enumerate(names):
        labels[mesh.get_group(a).group_name] = a
        if inside((i,)):
            intra.append(a)
    dp = tuple(a for a in ("pod", "data") if a in names)
    if len(dp) > 1:
        label = ",".join(dp)
        labels.setdefault(mesh[dp]._flatten().get_group().group_name, label)
        if inside(tuple(names.index(a) for a in dp)):
            intra.append(label)
    return labels, tuple(intra)


def _dtensor_bookkeeping():
    """DTensor's own planning, run paused by the counter: the op on global
    shapes that propagates an output's shape and strides (required); a
    strided shard's local size, which indexes real tensors, and a strategy
    found through an op's decomposition on a mesh of its own, both run
    with any fake mode unset (optional: where the release has them).
    Yields (owner, name, unset fake)."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if n in ShardingPropagator.__dict__]
    if not names:
        raise RuntimeError("DTensor's shape propagation has moved: the counter "
                           "would count global shapes")
    yield ShardingPropagator, names[0], False
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in strided.__dict__:
        yield strided, "local_shard_size_and_offset", True
    try:  # a strategy found by running an op's decomposition on a mesh of its own
        from torch.distributed.tensor._decompositions import DecompShardingStrategy
    except ImportError:
        return
    if "propagate_strategy" in DecompShardingStrategy.__dict__:
        yield DecompShardingStrategy, "propagate_strategy", True


class CostCounter(TorchDispatchMode):
    """Counts a run's per-device FLOPs, bytes, collective payloads and peak
    live bytes (module docstring). ``mesh`` (a DeviceMesh) names the
    collectives' process groups by axis. Enter it inside the
    ``FakeTensorMode`` a dry-run uses (or on real tensors); read
    :meth:`costs` after."""

    def __init__(self, mesh=None, dtype: str = "bfloat16"):
        super().__init__()
        self.groups, self.intra = mesh_groups(mesh) if mesh is not None else ({}, ())
        self.dtype = dtype
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.fused_bytes = 0.0
        self.collective = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._paused = 0
        self._patched = []

    # DTensor's bookkeeping runs paused
    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        for cls, name, unset in _dtensor_bookkeeping():
            orig = cls.__dict__[name]

            def paused(*args, _orig=orig, _unset=unset, **kwargs):
                self._paused += 1
                try:
                    if _unset:
                        with unset_fake_temporarily():
                            return _orig(*args, **kwargs)
                    return _orig(*args, **kwargs)
                finally:
                    self._paused -= 1

            setattr(cls, name, paused)
            self._patched.append((cls, name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            while self._patched:
                cls, name, orig = self._patched.pop()
                setattr(cls, name, orig)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the shards, which are counted
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _count(self, func, args, kwargs, out) -> None:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLLECTIVES and name in _COLLECTIVES[ns]:
            # the payload: the larger of what goes in and what comes out
            payload = float(max([_nbytes(a) for a in args] + [_nbytes(out)]))
            axis = self.groups.get(_group_name(func, args, kwargs), "unknown")
            self.collective[axis] = self.collective.get(axis, 0.0) + payload
        elif func.is_view or not any(isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            return
        self._track(out)
        in_b, out_b = _nbytes((args, kwargs)), _nbytes(out)
        self.bytes_accessed += in_b + out_b
        formula = _flop_formula(func._overloadpacket)
        if formula is not None:  # a product: operands and output
            self.flops += formula(*args, **kwargs, out_val=out)
            self.fused_bytes += in_b + out_b
        elif name == "_to_copy":  # a copy; a dtype cast is elementwise
            if out.dtype == args[0].dtype:
                self.fused_bytes += out_b
        elif name in _OUT_ONLY or name.rstrip("_") in _OUT_ONLY:
            self.fused_bytes += out_b

    def costs(self) -> CellCosts:
        return CellCosts(
            flops=self.flops,
            bytes_accessed=self.bytes_accessed,
            collective_bytes=sum(self.collective.values()),
            peak_memory_bytes=float(self.peak),
            fused_bytes=self.fused_bytes,
            collective_by_axis=dict(self.collective),
            intra_node_axes=self.intra,
            dtype=self.dtype,
        )


def _flop_formula(packet) -> Any:
    from torch.utils.flop_counter import flop_registry

    return flop_registry.get(packet)
