#!/usr/bin/env python3
"""The sharded steps on a ('data', 'model') mesh of several ranks, each
held to the unsharded step.

    python3 tools/sharded_mesh.py [--shape 2 2] [--device cuda] [--smoke]

Spawns one process a rank (NCCL on cuda:<rank>, or gloo with ``--device
cpu``) over a store on 127.0.0.1, builds the mesh of ``--shape`` and runs,
on every rank, each sharded part and the unsharded one from the same
state (the unsharded on the rank's own card):

a. SmolLM-135M at O2 (batch pins, kernel B4 on each rank's block, chunked
   CE): 3 ``jit_train_step`` steps of 4 x 2048 tokens. Loss and grad norm
   at rtol 1e-5; both AdamW moments within 1e-5 of each leaf's largest
   entry (v 2e-5); the parameters as AdamW moves the step's start with the
   sharded moments (the update m / (sqrt(v) + eps) is ill-conditioned
   where a gradient entry is near eps, so they are not held to the
   unsharded ones closer than 2 lr).
b. Its O3 ``jit_prefill_step`` on 4 x 2016 tokens and 32 ``jit_decode_step``
   steps: logits at atol 1e-5.
c. Qwen3-MoE-30B-A3B at full width, 4 of 48 layers, on the expert-parallel
   island: the prefill of 4 x 2016 (t_local * top_k = 32 256: the ZeRO
   path) and 32 decode steps at batch 4 (the tiny path) against ``ep=None``
   from the same parameters: logits at atol 2e-5 in every batch row none
   of whose tokens' top-k expert sets differ from the unsharded run's so
   far (another order of the same sums can flip a near tie, which moves
   that token's output by a whole expert's; the rows and tokens that flip
   are counted and printed, as phase 13b of ``chip_smoke.py`` counts
   them). The ZeRO path drops an expert shard's assignments past its
   capacity, t_local * top_k / ep * capacity_factor, where the local path
   drops none; random weights route unevenly, so the capacity factor is
   set to the ep axis's size, which drops nothing (the reference's tests
   use generous factors likewise).

d. After the ranks, in one process: a fleet of an odd seed count and the
   rollout lanes of ``batched_rollout_scores`` with ``devices="auto"``,
   which splits them over every card of the machine (one B1 launch a
   card), against ``devices="never"`` on one card: every field of the
   materialized and the streaming fleet, and the scores and ``best``,
   bitwise; under ``REPRO_DIAG=1``, so the device-to-device copies pass
   the hot-path guard that refuses host syncs. With ``--device cpu`` the
   private device-list functions run over as many CPU devices.

``--smoke`` runs the smoke configs at short lengths (a rehearsal on the
CPU). Rank 0 prints each part's walls, sharded and unsharded, and the
largest differences, then a JSON summary; part d prints its own JSON line
last. Every rank fails on a mismatch, and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import socket
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainState,
    build_model,
    gather,
    jit_decode_step,
    jit_prefill_step,
    jit_train_step,
    make_train_step,
    place,
)
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.tree import flatten_with_keys  # noqa: E402

RTOL, ATOL, MOE_ATOL = 1e-5, 1e-5, 2e-5


def sync_wall(dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t


def hold_state(got, want, start, opt: AdamW) -> dict:
    """One sharded step's gathered state against the unsharded step's from
    the same ``start`` (all full tensors); returns the largest differences
    relative to each leaf's largest entry."""
    got, want, start = (dict(flatten_with_keys(t)) for t in (got, want, start))
    step = int(want[".opt.step"])
    lr = float(opt.lr(torch.tensor(step)))
    bc1, bc2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    worst = dict(moments=0.0, update=0.0, params=0.0)
    for key, w in want.items():
        g = got[key].to(w.device)
        if key == ".opt.step":
            assert int(g) == step, (int(g), step)
            continue
        scale = float(w.abs().max()) or 1.0
        if key.startswith(".params"):
            name = key[len(".params"):]
            p0 = start[key].double()
            m, v = got[".opt.m" + name].double(), got[".opt.v" + name].double()
            u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p0
            err = float((g.double() - (p0 - lr * u)).abs().max())
            worst["update"] = max(worst["update"], err / scale)
            assert err <= 1e-6 * float(p0.abs().max()) + 1e-5 * lr, (key, err)
            apart = float((g - w).abs().max())
            worst["params"] = max(worst["params"], apart / scale)
            assert apart <= 2 * lr, (key, apart)
        else:
            rel = float((g - w).abs().max()) / scale
            worst["moments"] = max(worst["moments"], rel)
            assert rel <= RTOL * (2 if key.startswith(".opt.v") else 1), (key, rel)
    return worst


def train_part(dev, mesh, cfg, n: dict, say) -> dict:
    model = build_model(cfg, mesh, dtype=torch.float32, remat="none", opt="O2", device=dev)
    plain = build_model(cfg, None, dtype=torch.float32, remat="none", opt="O2", device=dev)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=20, total=600), weight_decay=0.01)
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    meta = torch.empty((n["batch"], n["seq"]), dtype=torch.int64, device="meta")
    step, _, state_sh, _ = jit_train_step(model, opt, mesh, {"tokens": meta})
    ref_step = make_train_step(plain, opt)
    state = place(TrainState(params, opt.init(params)), state_sh)
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = dict(walls=[], ref_walls=[], loss=0.0, grad_norm=0.0)
    for i in range(n["steps"]):
        batch = {"tokens": torch.randint(0, cfg.vocab, (n["batch"], n["seq"]), generator=gen,
                                         device=dev)}
        start = gather(state)
        (state, metrics), wall = sync_wall(dev, lambda: step(state, batch))
        (want, ref_metrics), ref_wall = sync_wall(dev, lambda: ref_step(start, batch))
        rec["walls"].append(wall)
        rec["ref_walls"].append(ref_wall)
        for key in ("loss", "grad_norm"):
            got, exp = float(gather(metrics[key])), float(ref_metrics[key])
            rec[key] = max(rec[key], abs(got - exp) / abs(exp))
            assert rec[key] <= RTOL, (i, key, got, exp)
        for key, v in hold_state(gather(state), want, start, opt).items():
            rec[key] = max(rec.get(key, 0.0), v)
        say(f"[a] step {i + 1}: loss {float(ref_metrics['loss']):.6f}; sharded "
            f"{wall * 1e3:.1f} ms, unsharded {ref_wall * 1e3:.1f} ms")
    return rec


@contextlib.contextmanager
def recorded_routes():
    """Every routing call's top-k experts, in call order (the rank's rows)."""
    fn, routes = moe_mod._route, []

    def recorder(x2d, router, mc):
        out = fn(x2d, router, mc)
        routes.append(torch.sort(out[1], -1)[0])
        return out

    moe_mod._route = recorder
    try:
        yield routes
    finally:
        moe_mod._route = fn


def flipped_rows(mesh, got: list, want: list, b: int) -> tuple[torch.Tensor, int]:
    """The batch rows (a bool (b,) tensor, the same on every rank) any of
    whose tokens has a top-k set in ``got`` (this rank's routing calls,
    its data shard's rows or all rows) other than in ``want`` (all rows),
    and the number of such tokens."""
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    rows = torch.zeros(b, dtype=torch.int32, device=dev)
    tokens = torch.zeros((), dtype=torch.int64, device=dev)
    d = mesh.get_local_rank("data")
    for g, w in zip(got, want):
        w = w.reshape(b, -1, w.shape[-1])
        if g.shape[0] != w.shape[0] * w.shape[1]:  # this rank's data shard
            lo = d * (b // mesh.size(0))
            w = w[lo:lo + b // mesh.size(0)]
        else:
            lo = 0
        differ = (g.reshape(w.shape) != w).any(-1)  # (rows, tokens)
        rows[lo:lo + w.shape[0]] |= differ.any(-1).int()
        tokens += differ.sum()
    dist.all_reduce(rows, op=dist.ReduceOp.MAX)
    dist.all_reduce(tokens)  # each flip is counted by every rank holding its row
    return rows.bool(), int(tokens) // mesh.size(1)


def serve_part(tag: str, dev, mesh, model, plain, params, n: dict, atol: float, say) -> dict:
    gen = torch.Generator(device=dev).manual_seed(2)
    b, p, steps = n["batch"], n["prompt"], n["steps"]
    toks = torch.randint(0, model.cfg.vocab, (b, p + steps), generator=gen, device=dev)
    i64 = lambda *shape: torch.empty(shape, dtype=torch.int64, device="meta")
    prefill, _, p_sh, _ = jit_prefill_step(model, mesh, {"tokens": i64(b, p)})
    cache_sds = dataclasses.replace(model, device=torch.device("meta")).empty_caches(b, p + steps)
    decode, *_ = jit_decode_step(model, mesh, {"token": i64(b), "pos": i64(b)}, cache_sds)
    sharded = place(params, p_sh)
    rec = dict(worst=0.0)
    routes = {}
    for name in ("sharded", "unsharded"):
        run_prefill = ((lambda: prefill(sharded, {"tokens": toks[:, :p]}, p + steps))
                       if name == "sharded" else
                       (lambda: plain.prefill(params, {"tokens": toks[:, :p]}, cache_len=p + steps)))
        with recorded_routes() as calls:
            (logits, caches), rec[f"{name}_prefill"] = sync_wall(dev, run_prefill)
            outs, walls, ends = [gather(logits)], [], [len(calls)]
            for t in range(steps):
                batch = {"token": toks[:, p + t],
                         "pos": torch.full((b,), p + t, dtype=torch.int64, device=dev)}
                run = ((lambda: decode(sharded, caches, batch)) if name == "sharded" else
                       (lambda: plain.decode_step(params, caches, batch)))
                (logits, caches), wall = sync_wall(dev, run)
                outs.append(gather(logits))
                walls.append(wall)
                ends.append(len(calls))
        rec[f"{name}_decode"] = sorted(walls)[len(walls) // 2]
        rec[name], routes[name] = outs, (list(calls), ends)
        del caches
    (got_calls, ends), (want_calls, _) = routes["sharded"], routes["unsharded"]
    rec.update(flipped_rows=0, flipped_tokens=0)
    for got, want, end in zip(rec.pop("sharded"), rec.pop("unsharded"), ends):
        rows, tokens = flipped_rows(mesh, got_calls[:end], want_calls[:end], b)
        rec.update(flipped_rows=int(rows.sum()), flipped_tokens=tokens)
        if bool((~rows).any()):
            rec["worst"] = max(rec["worst"], float((got - want)[~rows].abs().max()))
    flips = (f"; {rec['flipped_tokens']} tokens' top-k sets differ (in {rec['flipped_rows']} "
             f"of {b} rows, not held)" if want_calls else "")
    say(f"[{tag}] prefill {b} x {p}: sharded {rec['sharded_prefill'] * 1e3:.1f} ms, unsharded "
        f"{rec['unsharded_prefill'] * 1e3:.1f} ms; decode step (median of {steps}): sharded "
        f"{rec['sharded_decode'] * 1e3:.1f} ms, unsharded {rec['unsharded_decode'] * 1e3:.1f} "
        f"ms; largest |difference| {rec['worst']:.3g} (atol {atol}){flips}")
    assert rec["worst"] <= atol, (tag, rec["worst"])
    return rec


def rank_main(rank: int, world: int, port: int, args) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            device_id=dev if dev.type == "cuda" else None)
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else (lambda msg: None)
    try:
        mesh = init_device_mesh(dev.type, tuple(args.shape), mesh_dim_names=("data", "model"))
        config = get_smoke_config if args.smoke else get_config
        lens = (dict(batch=4, seq=64, prompt=24, steps=4) if args.smoke else
                dict(batch=4, seq=2048, prompt=2016, steps=32))
        say(f"[mesh] {tuple(mesh.shape)} ('data', 'model') over {world} ranks, "
            f"{dist.get_backend()}" + (f", NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
                                        f", {torch.cuda.get_device_name(dev)}"
                                        if dev.type == "cuda" else ""))
        t0 = time.perf_counter()
        cfg = config("smollm-135m")
        train = train_part(dev, mesh, cfg, dict(batch=lens["batch"], seq=lens["seq"], steps=3),
                           say)
        plain = build_model(cfg, None, dtype=torch.float32, remat="none", opt="O3", device=dev)
        params = plain.init(torch.Generator(device=dev).manual_seed(0))
        serve = serve_part("b", dev, mesh, build_model(cfg, mesh, dtype=torch.float32,
                                                       remat="none", opt="O3", device=dev),
                           plain, params, lens, ATOL, say)
        del plain, params
        moe_cfg = config("qwen3-moe-30b-a3b")
        moe_cfg = dataclasses.replace(moe_cfg, n_layers=4, moe=dataclasses.replace(
            moe_cfg.moe, capacity_factor=float(args.shape[1])))
        plain = build_model(moe_cfg, None, dtype=torch.float32, remat="none", opt="O3",
                            device=dev)
        model = build_model(moe_cfg, mesh, dtype=torch.float32, remat="none", opt="O3",
                            device=dev)
        assert model.ep is not None
        params = plain.init(torch.Generator(device=dev).manual_seed(0))
        moe = serve_part("c", dev, mesh, model, plain, params, lens, MOE_ATOL, say)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        say(f"[done] {time.perf_counter() - t0:.1f} s; peak {peak:.2f} GiB on rank 0")
        say(json.dumps({"ok": True, "shape": list(args.shape), "train": train, "serve": serve,
                        "moe": moe}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def fleet_and_lanes(device: str, n_dev: int, smoke: bool) -> dict:
    """Part d: the seed and lane sharding over ``n_dev`` devices against
    one device, bitwise, with the hot-path guard armed."""
    import os

    from repro_torch.core import project_capped_simplex
    from repro_torch.kernels.fcfs_queue import fcfs_scan
    from repro_torch.serving import router
    from repro_torch.storage import GeoFabric, init_carry, segment_draws, simulator, tahoe_testbed

    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    devices = [torch.device("cuda", i) if cuda else dev for i in range(n_dev)]
    cl = tahoe_testbed(device=dev)
    r, m, k = 6, 12, 4.0
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    lam = torch.tensor([0.030, 0.020, 0.015, 0.012, 0.010, 0.008], device=dev)
    pi = project_capped_simplex(torch.rand((r, m), generator=gen(1), device=dev),
                                torch.full((r,), k, device=dev))
    fabric = GeoFabric.single_site(cl)
    seeds, n = 2 * n_dev + 1, (2000 if smoke else 20_000)
    out, before = {}, os.environ.get("REPRO_DIAG")
    os.environ["REPRO_DIAG"] = "1"
    try:
        for label, kw in (("fleet", {}), ("stream", dict(stream=True, n_chunks=2))):
            args = (pi, lam[None], fabric, 150.0 / k, n, seeds)
            one = simulator.simulate_fleet(gen(2), *args, devices="never", **kw)
            fcfs_scan.launches = 0
            t = time.perf_counter()
            many = (simulator.simulate_fleet(gen(2), *args, devices="auto", **kw) if cuda else
                    simulator._simulate_fleet_on(devices, gen(2), *args, **kw))
            wall = time.perf_counter() - t
            same = all((a is None and b is None) or torch.equal(a, b) for a, b in (
                (getattr(many, f), getattr(one, f))
                for f in ("latency", "file_id", "site_id", "node_busy", "hit_count")))
            if kw:
                same = same and all(torch.equal(a, b) for part in ("stream", "windows")
                                    for a, b in zip(getattr(many, part), getattr(one, part)))
            out[label] = dict(seeds=seeds, requests=n, bitwise=same, launches=fcfs_scan.launches,
                              wall_s=wall)
            if not same:
                raise AssertionError(f"d {label}: the fleet over {n_dev} devices differs")
        d, rates = cl.service_params(150.0 / k)
        carry = init_carry(m, device=dev)
        avail = torch.ones(m, dtype=torch.bool, device=dev)
        for b, draws_k in ((8, 1), (5, 2)):
            pis = torch.stack([project_capped_simplex(
                torch.rand((r, m), generator=gen(10 + i), device=dev),
                torch.full((r,), k, device=dev)) for i in range(b)])
            cost = torch.rand((b,), generator=gen(3), device=dev)
            draws = segment_draws(gen(4), lam[None], 600, m, draws_k)
            a = (carry, None, pis, lam, d, rates, avail, cost, None)
            kw = dict(n_clients=r, n_requests=600, rollout_seeds=draws_k, draws=draws)
            want, want_best = router.batched_rollout_scores(*a, devices="never", **kw)
            fcfs_scan.launches = 0
            got, best = (router.batched_rollout_scores(*a, devices="auto", **kw) if cuda else
                         router._batched_rollout_scores_on(devices, *a, **kw))
            same = bool(torch.equal(got[:b], want[:b]) and int(best) == int(want_best))
            out[f"lanes_{b}x{draws_k}"] = dict(bitwise=same, launches=fcfs_scan.launches,
                                               best=int(best),
                                               pad=router._lane_pad(b, draws_k, n_dev))
            if not same:
                raise AssertionError(f"d lanes {b}x{draws_k}: differ over {n_dev} devices")
    finally:
        if before is None:
            del os.environ["REPRO_DIAG"]
        else:
            os.environ["REPRO_DIAG"] = before
    print(f"[d] the fleet and the lanes over {n_dev} devices == one device, bitwise, "
          f"REPRO_DIAG=1: {out}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    world = args.shape[0] * args.shape[1]
    if args.device == "cuda":
        if torch.cuda.device_count() < world:
            print(f"sharded_mesh: {world} ranks need {world} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 1
        fa.load_library()  # built once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(rank_main, args=(world, port, args), nprocs=world, start_method="spawn")
    d = fleet_and_lanes(args.device, world, args.smoke)
    print(json.dumps({"ok": True, "d": d}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
