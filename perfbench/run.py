"""Run one cell of `BENCHMARK.json` once on one CUDA device.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` also `breakdown`, and the
compared numbers under `compared`), and the compared numbers beside their
limits as the last lines on standard error. Exits non-zero, printing no
result, without a CUDA device, when the port cannot be imported, or when
`jax`, `jaxlib`, `flax` or the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # the read cells keep ~43 GB resident beside batches of GB-sized buffers
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    parts = {}
    try:
        import torch

        import repro_torch.storage  # noqa: F401
    except ImportError as err:
        print(f"perfbench: cannot import the port: {err}", file=sys.stderr)
        return 2
    from perfbench.harness import bench, result, runner

    cell = bench.resolve(args.workload)
    parts["imports_s"] = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=device)
    parts["cuda_init_s"] = time.perf_counter() - start
    from perfbench.harness import deploy

    deploy.load_kernels(cell, parts)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                          parts=parts)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    line = result.result_line(correct=out.correct, attempted=out.attempted, failed=out.failed,
                              metrics=out.metrics, device=out.device, compared=out.compared,
                              breakdown=out.breakdown)
    for text in result.compared_lines(out.compared):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
