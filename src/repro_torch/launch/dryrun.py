"""The multi-pod dry-run: each (architecture x input shape x mesh)
cell's step on fake tensors, counted per device against the H100's
roofline.

The port of ``repro/launch/dryrun.py``. Where the reference fakes 512 host
devices and compiles each cell's step, the port starts a fake default
process group of the mesh's size (256 ranks for the (16, 16) single pod,
512 for the (2, 16, 16) two pods; its collectives do nothing), builds the
mesh on the CPU and, under ``FakeTensorMode``, the model
(``build_model``), the train state, batch or caches as DTensors of this
rank's shards at the sharding rules' placements, and runs one
``jit_train_step``, ``jit_prefill_step`` or ``jit_decode_step`` inside
:class:`~.roofline.CostCounter`. Nothing touches a card: no kernel is
launched, and attention at O1 and up runs kernel B4's plain twin. An MoE
layer's expert products run as a shape-only grouped product
(``_experts_even``): fake group sizes cannot be read.

Per cell it records the per-device peak of live bytes (``fits_h100_80g``:
under 80e9), the counts, and (``with_roofline``, single-pod and local
meshes) the roofline terms with the reference's corrections where they
still apply:

* no loop correction: the port executes every layer, so the count at full
  depth is the count (``_unrolled_cfg`` stays, for the test that the
  count is linear in periods, which the reference's ``extrapolate``
  relies on);
* RWKV6's recurrence: in train and prefill a stand-in for its token loop
  (``_wkv_io_only``: the outputs' shapes from elementwise ops, no
  product) and the loop's FLOPs and I/O added analytically
  (``roofline.rwkv_counter_misses``, ``roofline.wkv_io_bytes``): a Python
  loop over 4 096 to 32 768 tokens a layer takes tens of minutes a cell
  under fake tensors. A decode step runs for real; the correction adds
  what the counter cannot see of it (the elementwise terms);
* the MoE's expert products: a stand-in for the static-shape path that
  ``models/moe.py`` takes on fake tensors (``_experts_even``: the grouped
  product with the ``cap`` rows dealt evenly over the local experts, the
  balanced routing the roofline assumes), so FLOPs, bytes and the peak
  are the grouped path's own and nothing is removed afterwards; the
  reference's ``moe_cpu_excess`` (what its CPU ``ragged_dot`` computes
  beyond the grouped product) is recorded, not subtracted;
* O1 and up: the memory term by decomposition, a run with the attention
  core stubbed out (``attn_impl="stub"``) plus kernel B4's exact q, k, v
  and out traffic (``flash_io_bytes``): the plain twin materializes tiles
  that B4 keeps on chip. FLOPs keep the full run.

Run (CPU only; one cell takes seconds to minutes):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh single --opt O2
``--mesh`` also takes ``RxC`` (a ('data', 'model') mesh of R x C fake
ranks) or ``PxRxC`` (('pod', 'data', 'model')), and ``--shape`` a
``kind:BxS`` cell (e.g. ``train:8x2048``) beside the registry's shape
names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import signal
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.launch.roofline import (
    PEAK_FLOPS,
    CellCosts,
    CostCounter,
    flash_io_bytes,
    model_flops,
    moe_cpu_excess,
    rwkv_counter_misses,
    wkv_io_bytes,
)
from repro_torch.launch.specs import batch_specs_for, cache_specs, cell_is_runnable
from repro_torch.launch.steps import (
    _abstract_params,
    build_model,
    jit_decode_step,
    jit_prefill_step,
    jit_train_step,
)
from repro_torch.models import SHAPES, moe, rwkv6
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import flatten_with_keys, tree_leaves, unflatten_like

FITS_BYTES = 80e9  # one H100's memory
CELL_TIMEOUT_S = 600  # a cell past it is recorded as TIMEOUT


def _unrolled_cfg(cfg, k: int):
    """Config with k periods laid out as prefix layers (no period)."""
    kinds = cfg.prefix + cfg.period * k + cfg.suffix
    return dataclasses.replace(
        cfg, n_layers=len(kinds), prefix=kinds, period=(), suffix=()
    )


def _active_params(cfg) -> tuple[int, int]:
    """(active, total) non-embedding params, from the parameter tree on
    ``meta``."""
    model = build_model(cfg, None, dtype=torch.bfloat16, remat="none", device="meta")
    abstract = _abstract_params(model)
    total = sum(x.numel() for x in tree_leaves(abstract))
    emb = abstract["embed"].numel()
    if "lm_head" in abstract:
        emb += abstract["lm_head"].numel()
    total -= emb
    active = total
    if cfg.moe is not None:
        mc = cfg.moe
        n_moe_layers = sum(1 for k in cfg.layer_kinds if k in ("moe", "mla"))
        per_expert = 3 * cfg.d_model * mc.d_ff_expert
        routed_total = n_moe_layers * mc.n_experts * per_expert
        routed_active = n_moe_layers * mc.top_k * per_expert
        active = total - routed_total + routed_active
    return active, total


# ------------------------------------------------------------ fake world
def fake_world(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0 (any other group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_mesh(mesh_kind: str):
    """The CPU mesh of a mesh kind ("single", "multi", "RxC" as ('data',
    'model') or "PxRxC" as ('pod', 'data', 'model')) in a fake world of its
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh

    if mesh_kind in ("single", "multi"):
        fake_world(512 if mesh_kind == "multi" else 256)
        return make_production_mesh(multi_pod=mesh_kind == "multi", device_type="cpu")
    shape = tuple(int(n) for n in mesh_kind.split("x"))
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model")[-len(shape):])


def parse_shape(name: str) -> ShapeConfig:
    """A registry shape name, or ``kind:BxS`` (e.g. ``train:8x2048``)."""
    if name in SHAPES:
        return SHAPES[name]
    kind, dims = name.split(":")
    b, s = (int(n) for n in dims.split("x"))
    return ShapeConfig(name, s, b, kind)


def _local_shapes(tree, shardings) -> dict:
    """Each leaf's (local shape, mesh, placements) at ``shardings``: this
    rank's shard (computed on real tensors, outside the fake mode)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    sh = dict(flatten_with_keys(shardings))
    out = {}
    for key, leaf in flatten_with_keys(tree):
        mesh, pl = sh[key].mesh, sh[key].placements
        out[key] = (compute_local_shape_and_global_offset(leaf.shape, mesh, pl)[0], mesh, pl)
    return out


def _shards(tree, local: dict):
    """``tree`` (``meta`` leaves) as DTensors holding this rank's shards
    (``_local_shapes``), made where the caller is: fake tensors under
    ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor

    def one(key, leaf):
        shape, mesh, pl = local[key]
        return DTensor.from_local(torch.empty(shape, dtype=leaf.dtype), mesh, pl,
                                  run_check=False, shape=leaf.shape, stride=leaf.stride())

    return unflatten_like(tree, {k: one(k, leaf) for k, leaf in flatten_with_keys(tree)})


def _wkv_io_only(r, k, v, w, u, state0):
    """A stand-in for ``rwkv6._wkv_scan`` in the dry-run: outputs of its
    shapes, dtypes and placements (o (B,S,H,hd) and the state (B,H,hd,hd),
    float32), differentiable in every input, from elementwise ops and sums
    over the tokens, so no product and no fused bytes; the recurrence's own
    are added analytically. On a mesh it runs on each rank's block, as the
    loop does."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.blocks import local_blocks

    if isinstance(r, DTensor):
        return local_blocks(_wkv_io_only, (r, k, v, w, u, state0),
                            [(0, 2)] * 4 + [(None, 0), (0, 1)], [(0, 2), (0, 1)])
    o = r.float() * k.float() * v.float() * w.float() * u.float()
    kv = k.float().sum(1)[..., :, None] * v.float().sum(1)[..., None, :]
    return o, state0 * w.float().prod(1)[..., None] + kv


def _experts_even(x_sorted, e_sorted, w_gate, w_up, w_down):
    """A stand-in for ``moe._expert_compute_static`` in the dry-run: the
    grouped SwiGLU of ``moe._expert_compute`` with the rows dealt evenly
    over the local experts, the first ``rows % E_local`` one row more. Its
    group sizes need no values, so it runs on fake tensors and counts the
    grouped path's FLOPs, bytes and saved products."""
    n, rows = w_gate.shape[0], x_sorted.shape[0]
    sizes = [rows // n + (e < rows % n) for e in range(n)]
    gates, ups, downs = torch.unbind(w_gate), torch.unbind(w_up), torch.unbind(w_down)
    return torch.cat([(F.silu(r @ gates[e]) * (r @ ups[e])) @ downs[e]
                      for e, r in enumerate(torch.split(x_sorted, sizes)) if r.shape[0]])


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum((x.to_local() if isinstance(x, DTensor) else x).untyped_storage().nbytes()
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def cell_costs(cfg, shape: ShapeConfig, mesh, opt: str = "O0", attn_stub: bool = False,
               dtype=torch.bfloat16) -> tuple[CellCosts, dict]:
    """One step of ``cfg`` at ``shape`` on ``mesh`` under fake tensors,
    counted per device. Returns (costs, memory analysis in the
    reference's keys: arguments, outputs, temporaries)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg, mesh, dtype=dtype, remat="dots", opt=opt, device="cpu")
    if attn_stub:  # roofline decomposition probe (see roofline.flash_io_bytes)
        model = dataclasses.replace(model, attn_impl="stub")
    batch_sds = batch_specs_for(cfg, shape)
    if shape.kind == "train":
        step, abstract, state_sh, batch_sh = jit_train_step(model, AdamW(lr=1e-4), mesh, batch_sds)
        trees = [(abstract, state_sh), (batch_sds, batch_sh)]
    elif shape.kind == "prefill":
        step, abstract, p_sh, batch_sh = jit_prefill_step(model, mesh, batch_sds)
        trees = [(abstract, p_sh), (batch_sds, batch_sh)]
    else:
        c_sds = cache_specs(model, shape)
        step, abstract, p_sh, c_sh, batch_sh = jit_decode_step(model, mesh, batch_sds, c_sds)
        trees = [(abstract, p_sh), (c_sds, c_sh), (batch_sds, batch_sh)]
    plans = [(tree, _local_shapes(tree, sh)) for tree, sh in trees]
    counter = CostCounter(mesh, dtype=str(dtype).removeprefix("torch."))
    wkv_scan, rwkv6._wkv_scan = rwkv6._wkv_scan, _wkv_io_only
    static, moe._expert_compute_static = moe._expert_compute_static, _experts_even
    try:
        with FakeTensorMode(), counter:  # the counter above: it sees every op first
            args = tuple(_shards(tree, local) for tree, local in plans)
            arg_bytes = counter.live
            out = step(*args)
            out_bytes = _local_bytes(out)
    finally:
        rwkv6._wkv_scan, moe._expert_compute_static = wkv_scan, static
    costs = counter.costs()
    return costs, {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(costs.peak_memory_bytes - arg_bytes),
        "generated_code_size_in_bytes": 0,
    }


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, *, with_roofline: bool, opt: str = "O0",
    smoke: bool = False,
):
    """One cell's record (the reference's keys). ``smoke`` takes the
    arch's smoke config (tests)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = parse_shape(shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "opt": opt}
    if shape_name in SHAPES:
        runnable, why = cell_is_runnable(arch, shape_name)
        if not runnable:
            rec["status"] = "skipped"
            rec["reason"] = why
            return rec

    mesh = make_mesh(mesh_kind)
    chips = mesh.size()
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    t0 = time.time()
    costs, mem = cell_costs(cfg, shape, mesh, opt)
    rec["compile_s"] = round(time.time() - t0, 1)  # the fake run's wall
    rec["memory_analysis"] = mem
    # per-device steady-state estimate: args (params+opt+caches) + temps
    per_dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rec["per_device_bytes"] = per_dev
    rec["fits_h100_80g"] = bool(per_dev < FITS_BYTES)
    rec["raw"] = dataclasses.asdict(costs)

    if with_roofline:
        corrected = dataclasses.replace(costs)
        corrected.flops += rwkv_counter_misses(cfg, shape, mesh_shape)
        corrected.fused_bytes += wkv_io_bytes(cfg, shape, mesh_shape)
        adjusted = dataclasses.replace(corrected)
        flash_io = 0.0
        if opt != "O0" and "rwkv" not in cfg.period:
            stub, _ = cell_costs(cfg, shape, mesh, opt, attn_stub=True)
            flash_io = flash_io_bytes(cfg, shape, mesh_shape)
            adjusted.fused_bytes = stub.fused_bytes + flash_io
        rec["corrected"] = dataclasses.asdict(corrected)
        rec["moe_cpu_excess_flops"] = moe_cpu_excess(cfg, shape, mesh_shape)
        rec["flash_io_bytes"] = flash_io
        rec["roofline"] = adjusted.roofline(chips)
        active, total = _active_params(cfg)
        mf = model_flops(cfg, shape, active, total)
        rec["model_flops"] = mf
        rec["active_params"] = active
        rec["total_params_nonemb"] = total
        per_dev_model = mf / chips
        rec["useful_flops_ratio"] = per_dev_model / adjusted.flops if adjusted.flops else None
        rec["roofline_fraction"] = (
            (per_dev_model / PEAK_FLOPS) / rec["roofline"]["bound_step_s"]
            if rec["roofline"]["bound_step_s"]
            else None
        )
        rec["wall_s"] = round(time.time() - t0, 1)
    rec["status"] = "ok"
    return rec


class CellTimeout(BaseException):
    """A cell past its time (a BaseException: DTensor wraps an Exception
    raised inside its propagation into a RuntimeError)."""


def _cell(args):
    """One cell (in a worker process with ``--jobs``): its record, a fault
    recorded as ``FAILED``, a cell past ``CELL_TIMEOUT_S`` as
    ``TIMEOUT``."""
    arch, shape, mesh_kind, opt, with_roofline = args
    torch.set_num_threads(1)  # fake tensors compute nothing; cells run side by side
    for name in ("torch.distributed.tensor._redistribute", "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "opt": opt}
    t0 = time.time()

    def expire(*_):
        raise CellTimeout(f"the cell passed {CELL_TIMEOUT_S} s")

    signal.signal(signal.SIGALRM, expire)
    signal.alarm(CELL_TIMEOUT_S)
    try:
        return run_cell(arch, shape, mesh_kind, with_roofline=with_roofline, opt=opt)
    except CellTimeout as e:
        return dict(rec, status="TIMEOUT", error=str(e), compile_s=round(time.time() - t0, 1))
    except Exception as e:  # a failing cell is a fault: record it
        return dict(rec, status="FAILED", error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc()[-2000:])
    finally:
        signal.alarm(0)
        if dist.is_initialized():
            dist.destroy_process_group()


def _line(rec) -> str:
    label = f"{rec['arch']} x {rec['shape']} x {rec['mesh']} x {rec['opt']}"
    extra = ""
    if rec["status"] == "ok":
        extra = (f" fits={rec['fits_h100_80g']}"
                 f" per_dev={rec['per_device_bytes'] / 1e9:.2f}GB {rec['compile_s']}s")
        if "roofline" in rec:
            r = rec["roofline"]
            extra += (f" dominant={r['dominant']} bound={r['bound_step_s']:.4f}s"
                      f" frac={rec.get('roofline_fraction') or 0:.2%}")
    return f"[dryrun] {label:55s} {rec['status']}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--opt", default="O0", help="O0..O4 (launch/steps.py OPT_LEVELS)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in a fresh process (its own fake world)")
    args = ap.parse_args(argv)
    out_path = Path(args.out)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if args.append and out_path.exists():
        results = json.loads(out_path.read_text())
    done = {(r["arch"], r["shape"], r["mesh"], r.get("opt", "O0")) for r in results}
    cells = [(arch, shape, mesh_kind, args.opt, not args.no_roofline and mesh_kind != "multi")
             for arch in archs for shape in shapes for mesh_kind in meshes
             if (arch, shape, mesh_kind, args.opt) not in done]

    t_sweep = time.time()
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn"),
                                   max_tasks_per_child=1)
        records = pool.map(_cell, cells)
    else:
        records = map(_cell, cells)
    for rec in records:
        print(_line(rec), flush=True)
        results.append(rec)
        out_path.write_text(json.dumps(results, indent=1))
    if args.jobs > 1:
        pool.shutdown()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    n_late = sum(r["status"] == "TIMEOUT" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed, {n_late} timed out "
          f"in {time.time() - t_sweep:.1f} s")
    return 1 if n_fail or n_late else 0


if __name__ == "__main__":
    raise SystemExit(main())
