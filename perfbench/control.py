"""Read the numbers `correct` compares, for the program, its control or a
fault, on several seeds in one process (one set-up each).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds <s> \
        --system program|control|unchanged|half_batch|altered

Prints one JSON line a seed. The benchmark's own runs never run this: it
gives the readings the limits are set from (`PERF.md`), at the cell's own
size on the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--system", default="program")
    args = p.parse_args(argv)
    run._environment()
    import torch

    from perfbench.harness import bench, deploy, runner
    from perfbench.harness.common import clock

    cell = bench.resolve(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)  # the context, before its memory statistics
    parts = {}
    deploy.load_kernels(cell, parts)
    driver = bench.driver(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        system = {"program": None, "control": driver.control()}.get(args.system)
        if args.system not in ("program", "control"):
            system = driver.fault(args.system)
        torch.cuda.reset_peak_memory_stats(device)
        out = runner.run_cell(cell, seed, args.seconds, False, device, clock(), system=system,
                              parts=dict(parts))
        print(json.dumps(dict(seed=seed, system=args.system, correct=out.correct,
                              compared={k: v[0] for k, v in out.compared.items()},
                              metrics={k: v["value"] for k, v in out.metrics.items()},
                              peak=out.device["memory_peak_bytes"])), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
