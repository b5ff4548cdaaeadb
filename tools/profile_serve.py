#!/usr/bin/env python3
"""Where one SmolLM-135M serve batch spends its time on the card.

    python3 tools/profile_serve.py [--batch 4] [--prompt-len 2016] [--gen-len 32]

Builds the model as ``repro_torch.launch.serve`` does (level O3, float32,
random weights from seed 0), warms up with one full batch, then traces one
prefill and, separately, the greedy decode steps after it with
``torch.profiler``. For each it prints the host wall (ending in a device
synchronise), the device time summed over the kernels the trace recorded,
the idle share 1 - device / wall, the number of kernels launched and the
kernels that took the most device time. It needs a CUDA card, and fails if
the trace holds no device time.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.steps import build_model  # noqa: E402


def traced(label: str, fn, top: int = 8):
    """Run ``fn`` under the profiler; print its wall, device time and the
    heaviest kernels. Returns ``fn``'s result."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.name][0] += 1
            by_name[event.name][1] += event.time_range.elapsed_us()
    device_us = sum(us for _, us in by_name.values())
    if device_us <= 0:
        raise RuntimeError(f"{label}: the trace recorded no device time")
    launches = sum(n for n, _ in by_name.values())
    print(f"[{label}] wall {wall_us / 1e3:.3f} ms, device {device_us / 1e3:.3f} ms, "
          f"idle share {1 - device_us / wall_us:.4f}, {launches} kernels")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[{label}]   {us / 1e3:9.3f} ms {100 * us / device_us:5.1f} %  x{n:<5} {name[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2016)
    ap.add_argument("--gen-len", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = build_model(get_config("smollm-135m"), dtype=torch.float32, opt="O3", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    cache_len = args.prompt_len + args.gen_len
    toks = torch.randint(0, model.cfg.vocab, (args.batch, args.prompt_len),
                         generator=gen, device=dev)

    def prefill():
        return model.prefill(params, {"tokens": toks}, cache_len=cache_len)

    def decode(logits, caches):
        tok = torch.argmax(logits, -1)
        for t in range(args.gen_len):
            pos = torch.full((args.batch,), args.prompt_len + t, dtype=torch.int64, device=dev)
            logits, caches = model.decode_step(params, caches, {"token": tok, "pos": pos})
            tok = torch.argmax(logits, -1)
        return tok

    print(f"torch {torch.__version__} on {torch.cuda.get_device_name(0)}; batch {args.batch}, "
          f"prompt {args.prompt_len}, {args.gen_len} generated tokens")
    decode(*prefill())  # warm-up
    logits, caches = traced("prefill", prefill)
    traced(f"decode x{args.gen_len}", lambda: decode(logits, caches))
    return 0


if __name__ == "__main__":
    sys.exit(main())
