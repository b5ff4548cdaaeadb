"""Worlds of gloo ranks on the CPU for the port's multi-device layer.

One card admits one NCCL rank, so a mesh of several ranks is tested here:
``run_ranks`` spawns a world of processes on 127.0.0.1, each with a gloo
default group and torch on one thread, runs a module-level function in
each, and joins them within a time limit of its own (the ranks are killed
past it). The rank bodies of ``test_torch_moe_ep.py`` and
``test_torch_sharded_steps.py`` live here: this module imports neither
JAX nor the reference, so a spawned rank starts with torch and the port
only. Each body reads its inputs from a ``torch.save`` file and rank 0
writes its results to another.
"""
from __future__ import annotations

import socket
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

JOIN_TIMEOUT = 240.0  # seconds a world may take, spawn included


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn, world: int, port: int, args: tuple):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_worlds(jobs, timeout: float = JOIN_TIMEOUT) -> None:
    """Each ``(fn, world, args)`` of ``jobs`` as a world of ``world``
    spawned gloo ranks running ``fn(rank, *args)``, all at once; raises if a
    rank raises or the worlds outlast ``timeout`` (every rank is killed)."""
    ctxs = [mp.start_processes(_entry, args=(fn, world, _free_port(), args), nprocs=world,
                               join=False, start_method="spawn")
            for fn, world, args in jobs]
    deadline = time.monotonic() + timeout
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{len(jobs)} world(s) outlasted {timeout} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()


def run_ranks(fn, world: int, *args, timeout: float = JOIN_TIMEOUT) -> None:
    """``fn(rank, *args)`` in one world of ``world`` spawned gloo ranks."""
    run_worlds([(fn, world, args)], timeout)


def mesh_2x2():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def full_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: full(x).detach().clone(), tree)


# ------------------------------------------------------------- rank bodies
def moe_ep_rank(rank: int, inp: str, out: str) -> None:
    """The EP island on a (2, 2) ('data', 'model') mesh for every case of
    ``inp``: y, aux and the gradients of sum(y * gy) + aux_scale * aux for
    every parameter and for x."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import placements, spec_for_leaf
    from repro_torch.models.moe import EPSpec, moe_apply
    from repro_torch.tree import flatten_with_keys, unflatten_like

    mesh = mesh_2x2()
    ep = EPSpec(mesh=mesh, ep_axis="model", fsdp_axes=("data",), dp_axes=("data",))
    results = {}
    for name, case in torch.load(inp, weights_only=False).items():
        cfg = get_smoke_config(case["arch"])
        leaves = {
            key: distribute_tensor(
                v, mesh, placements(spec_for_leaf("['moe']" + key, v, mesh), mesh)
            ).requires_grad_()
            for key, v in flatten_with_keys(case["params"])
        }
        # the batch over 'data' where it divides it, else replicated, as
        # the sharding rules place a batch
        batch = [Shard(0) if case["x"].shape[0] % 2 == 0 else Replicate(), Replicate()]
        x = distribute_tensor(case["x"], mesh, batch).requires_grad_()
        y, aux = moe_apply(unflatten_like(case["params"], leaves), x, cfg, ep)
        loss = torch.sum(y * distribute_tensor(case["gy"], mesh, batch)) + case["aux_scale"] * aux
        loss.backward()
        results[name] = {
            "y": full(y).detach(), "aux": full(aux).detach(), "x_grad": full(x.grad),
            "grads": {key: full(v.grad) for key, v in leaves.items()},
        }
    if rank == 0:
        torch.save(results, out)


def sharded_steps_rank(rank: int, inp: str, out: str) -> None:
    """On ``inp``'s mesh (a (2, 2) ('data', 'model') mesh unless it names
    another shape, three dims being ('pod', 'data', 'model')):
    ``jit_train_step`` for each train case of ``inp`` (each step's metrics
    and state, and the model's aux loss at the first state), then the
    sharded prefill and decode steps of each serve case (each step's
    logits and the final caches)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.specs import cache_specs
    from repro_torch.launch.steps import (
        TrainState, build_model, jit_decode_step, jit_prefill_step, jit_train_step, place)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamW, cosine_schedule

    from torch.distributed.device_mesh import init_device_mesh

    cases = torch.load(inp, weights_only=False)
    shape = cases.get("mesh", (2, 2))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model")[-len(shape):])
    results = {"train": {}, "serve": {}}
    for name, case in cases["train"].items():
        cfg = get_smoke_config(case["arch"])
        model = build_model(cfg, mesh, dtype=torch.float32, remat="none", opt=case["opt"],
                            device="cpu")
        opt = AdamW(lr=cosine_schedule(**case["lr"]))
        step, _, state_sh, batch_sh = jit_train_step(model, opt, mesh, case["batches"][0])
        state = place(TrainState(case["params"], opt.init(case["params"])), state_sh)
        with torch.no_grad(), implicit_replication():
            aux = model._hidden(state.params, place(case["batches"][0], batch_sh))[1]
        metrics, states = [], []
        for batch in case["batches"]:
            state, m = step(state, batch)
            metrics.append({k: full(v) for k, v in m.items()})
            states.append(full_tree(state))
        results["train"][name] = {"metrics": metrics, "aux": full(aux), "states": states}
    for name, case in cases["serve"].items():
        cfg = get_smoke_config(case["arch"])
        model = build_model(cfg, mesh, dtype=torch.float32, opt="O3", device="cpu")
        toks = case["tokens"]
        b, s = toks.shape
        prefill, _, p_sh, _ = jit_prefill_step(model, mesh, {"tokens": toks})
        cache_sds = cache_specs(model, ShapeConfig("serve", case["cache_len"], b, "decode"))
        decode, *_ = jit_decode_step(model, mesh, {"token": toks[:, 0], "pos": toks[:, 0]},
                                     cache_sds)
        params = place(case["params"], p_sh)
        logits, caches = prefill(params, {"tokens": toks}, case["cache_len"])
        out_logits = [full(logits)]
        for t in range(case["steps"]):
            batch = {"token": case["feed"][:, t], "pos": torch.full((b,), s + t)}
            logits, caches = decode(params, caches, batch)
            out_logits.append(full(logits))
        results["serve"][name] = {"logits": out_logits, "caches": full_tree(caches)}
    if rank == 0:
        torch.save(results, out)


def _collectives_rank(rank: int, out: str) -> None:
    """A DTensor product and the island's all-gather on a (2, 2) mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe

    mesh = mesh_2x2()
    a = torch.arange(24.0).reshape(4, 6)
    b = torch.arange(18.0).reshape(6, 3)
    prod = distribute_tensor(a, mesh, [Shard(0), Replicate()]) @ distribute_tensor(
        b, mesh, [Replicate(), Shard(1)])
    x = torch.full((2, 3), float(mesh.get_local_rank("data")))
    x.requires_grad_()
    g = moe._all_gather(x, mesh, ("data",), 0)
    (g * torch.arange(4.0)[:, None]).sum().backward()
    got = {"prod": prod.full_tensor(), "gathered": g.detach(), "x_grad": x.grad}
    if rank == 0:
        torch.save(got, out)


def _hang_rank(rank: int) -> None:
    time.sleep(60)


# ------------------------------------------------------------------ tests
def test_a_world_of_four_runs_a_sharded_product_and_an_all_gather(tmp_path):
    out = str(tmp_path / "out.pt")
    run_ranks(_collectives_rank, 4, out)
    got = torch.load(out, weights_only=False)
    want = torch.arange(24.0).reshape(4, 6) @ torch.arange(18.0).reshape(6, 3)
    assert torch.equal(got["prod"], want)
    # rows of data rank 0, then of data rank 1 (JAX's tiled order)
    assert torch.equal(got["gathered"], torch.tensor([0.0, 1.0]).repeat_interleave(2)[:, None]
                       .expand(4, 3))
    # the backward sums each rank's rows over the data axis: 2 ranks each
    # wanted rows 0, 1 (weights 0, 1) from data rank 0
    assert torch.equal(got["x_grad"], torch.tensor([[0.0] * 3, [1.0] * 3]) * 2)


def test_a_world_past_its_time_limit_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(_hang_rank, 2, timeout=3.0)
    assert time.monotonic() - t0 < 30
