"""Serving loop: batched generation behind the probabilistic router.

The port of ``repro/launch/serve.py``. It builds the model at the
reference's serving level O3, whose prefill attention is the chunked path
(kernel B4 on the card), times one decode step, turns that time into
service moments for a pool of replicas with a synthetic skew, plans the
dispatch with JLCM (``Router.plan``), and then, for each batch, routes it
with Madow sampling (``Router.route``), prefills a random prompt and
decodes greedily. Weights are random, drawn from ``seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --batches 8

runs SmolLM-135M at full width and depth on the card (``--device cpu`` runs
on the host); ``--arch`` serves any architecture the registry builds:
``smollm-135m``, ``starcoder2-15b``, ``phi4-mini-3.8b``, ``gemma3-27b``,
``qwen3-moe-30b-a3b``, ``deepseek-v3-671b`` (MLA and 256 routed experts;
its 671B parameters do not fit one card with ``--full``, its smoke config
runs), ``qwen2-vl-2b``, ``seamless-m4t-medium``, ``recurrentgemma-2b`` and
``rwkv6-1.6b``. Two fail in their first prefill, as in the reference:
Qwen2-VL, whose M-RoPE needs (3, B, S) positions, and SeamlessM4T-medium,
whose encoder needs the stub frontend's ``enc_embeds``; serving with text
prompts makes neither. On
the card TF32 is switched off: the projections are float32 matmuls, and
TF32 would break parity with the reference.

As in the reference, the model is built on ``make_local_mesh`` (an MoE
arch gets its expert-parallel island); the parameters are placed by the
sharding rules once, and prefill and decode run through
``jit_prefill_step`` and ``jit_decode_step``, eager steps over DTensors.
``ServeRun.params`` holds the plain parameters as ``Model.init`` made them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch import Tensor

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import exponential_moments
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (
    build_model,
    gather,
    jit_decode_step,
    jit_prefill_step,
    place,
)
from repro_torch.models import Model
from repro_torch.serving import ReplicaPool, Router
from repro_torch.storage.cluster import _device


@dataclasses.dataclass
class ServeRun:
    """What one ``serve`` call did. Times are host seconds around work that
    ends in a device synchronise."""

    latencies: list[float]  # per batch, scaled by the routed replica's skew
    replicas: list[list[int]]  # the replicas each batch was routed to
    prompts: list[Tensor]  # per batch, (batch, prompt_len) token ids
    tokens: list[Tensor]  # per batch, (batch, gen_len + 1) greedy tokens
    prefill_s: list[float]  # per batch, the prefill alone
    decode_s: list[float]  # per batch, the gen_len decode steps
    step_ms: float  # the timed decode step that sets the service rates
    router: Router
    model: Model
    params: dict


def serve(
    arch: str = "smollm-135m",
    *,
    smoke: bool = True,
    n_replicas: int = 4,
    batch: int = 4,
    prompt_len: int = 16,
    gen_len: int = 16,
    n_batches: int = 8,
    hedge: int = 0,
    device="cuda",
    seed: int = 0,
) -> ServeRun:
    dev = _device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    mesh = make_local_mesh(dev)
    model = build_model(cfg, mesh, dtype=torch.float32, remat="none", opt="O3", device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    cache_len = prompt_len + gen_len
    prefill, decode = _steps(model, mesh, params, batch, prompt_len, cache_len)

    def prompt() -> Tensor:
        return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev)

    def positions(p: int) -> Tensor:
        return torch.full((batch,), p, dtype=torch.int64, device=dev)

    # replica pool: measured step time per replica with synthetic skew
    logits, caches = prefill(prompt())
    tok = torch.argmax(logits, -1)
    logits, caches = decode(caches, {"token": tok, "pos": positions(prompt_len)})  # warm-up
    sync()
    t0 = time.perf_counter()
    logits, caches = decode(caches, {"token": tok, "pos": positions(prompt_len + 1)})
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    skew = torch.linspace(1.0, 0.6, n_replicas)
    mu = 1000.0 / (ms * gen_len) * skew
    pool = ReplicaPool(moments=exponential_moments(mu.to(dev)),
                       cost=torch.ones((n_replicas,), device=dev))
    router = Router.plan(pool, torch.tensor([0.3 * float(mu.sum())]), hedge=hedge)
    print(f"[serve] {arch}: {ms:.2f} ms/token; router pi = "
          f"{np.round(router.pi[0], 3)} (bound {router.latency_bound:.3f}s)")

    route_gen = torch.Generator().manual_seed(seed + 1)
    run = ServeRun([], [], [], [], [], [], ms, router, model, params)
    for bi in range(n_batches):
        replicas = router.route(0, generator=route_gen)
        sync()
        t0 = time.perf_counter()
        toks = prompt()
        logits, caches = prefill(toks)
        tok = torch.argmax(logits, -1)
        sync()
        t1 = time.perf_counter()
        out = [tok]
        for t in range(gen_len):
            step = {"token": tok, "pos": positions(prompt_len + t)}
            logits, caches = decode(caches, step)
            tok = torch.argmax(logits, -1)
            out.append(tok)
        sync()
        t2 = time.perf_counter()
        # replica skew modelled as service-rate scaling of the real compute
        wall = (t2 - t0) / float(skew[min(replicas)])
        run.latencies.append(wall)
        run.replicas.append(replicas)
        run.prompts.append(toks)
        run.tokens.append(torch.stack(out, dim=1))
        run.prefill_s.append(t1 - t0)
        run.decode_s.append(t2 - t1)
        print(f"[serve] batch {bi}: replica(s) {replicas}, latency {wall * 1e3:.1f} ms")
    lat = np.asarray(run.latencies)
    print(f"[serve] mean {lat.mean() * 1e3:.1f} ms  p95 {np.quantile(lat, .95) * 1e3:.1f} ms")
    return run


def _steps(model: Model, mesh, params, batch: int, prompt_len: int, cache_len: int):
    """``prefill(tokens)`` and ``decode(caches, step)``, each giving (plain
    logits, caches): the sharded steps on ``mesh`` over parameters placed
    once."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.int64, device="meta")
    prefill_fn, _, p_sh, _ = jit_prefill_step(model, mesh, {"tokens": meta(batch, prompt_len)})
    cache_sds = dataclasses.replace(model, device=torch.device("meta")).empty_caches(
        batch, cache_len)
    decode_fn, *_ = jit_decode_step(model, mesh, {"token": meta(batch), "pos": meta(batch)},
                                    cache_sds)
    sharded = place(params, p_sh)

    def prefill(toks):
        logits, caches = prefill_fn(sharded, {"tokens": toks}, cache_len)
        return gather(logits), caches

    def decode(caches, step):
        logits, caches = decode_fn(sharded, caches, step)
        return gather(logits), caches

    return prefill, decode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--hedge", type=int, default=0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, smoke=not args.full, hedge=args.hedge, n_batches=args.batches,
          prompt_len=args.prompt_len, gen_len=args.gen_len, device=args.device)


if __name__ == "__main__":
    main()
