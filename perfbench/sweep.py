"""Find the read path's knee: one set-up, then a window at each offered rate.

    python3 perfbench/sweep.py --workload <read cell> --seed <n> --seconds <s> --rates 500,1000,2000

Prints one JSON line a rate: the read latencies' median and 95th percentile,
the reads still queued when the window closed, the mean batch, and how long
the drain ran past the close. The knee is the highest rate whose backlog
stays near empty; a read cell's traffic file records it.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    run._environment()
    import torch

    from perfbench.harness import bench, deploy, reads
    from perfbench.harness.common import Spans
    from perfbench.harness.system import System

    cell = bench.resolve(args.workload)
    if cell.traffic["driver"] != "reads" or not torch.cuda.is_available():
        print("perfbench: the sweep takes a read cell and a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    parts = {}
    deploy.load_kernels(cell, parts)
    rates = [float(r) for r in args.rates.split(",")]
    st = reads.setup(cell, args.seed, args.seconds, device, Spans(), System(), parts,
                     rate=rates[0])
    print(json.dumps({"setup_parts": parts}), flush=True)
    for rate in rates:
        reads.plan_schedule(st, rate)
        win = reads.window(st)
        print(json.dumps(dict(win["values"], **win["info"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
