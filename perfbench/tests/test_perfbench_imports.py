"""What the benchmark loads: nothing of JAX or the JAX package."""
from __future__ import annotations

import subprocess
import sys

from perfbench.harness import bench

CODE = r"""
import runpy, sys
sys.path[:0] = [{root!r}, {src!r}]
import perfbench.run as run
run._environment()
import perfbench.control, perfbench.sweep
from perfbench.harness import bench, checks, deploy, reads, runner, writes
for m in bench.load_benchmark()["per_layer"]:
    bench.metric_reader(m["name"])
print("FOUND", run.forbidden_modules())
print("PORT", "repro_torch" in sys.modules)
"""


def test_no_module_named_jax_or_the_jax_package_is_loaded():
    root = str(bench.ROOT)
    code = CODE.format(root=root, src=str(bench.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(bench.ROOT / "perfbench"),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout, out.stdout
    assert "PORT True" in out.stdout  # the port's name only begins with the JAX package's


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(bench.ROOT / "perfbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torchx"] = sys.modules[__name__]
        sys.modules["jaxlib.fake"] = sys.modules[__name__]
        found = run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    assert "jaxlib.fake" in found and "repro_torchx" not in found


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Only BENCHMARK.json and perfbench/: the port is missing, so the run
    exits non-zero and prints no result line."""
    import os
    import shutil

    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = bench.load_benchmark()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=240,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "cannot import the port" in out.stderr, out.stderr[-2000:]
    assert '"correct"' not in out.stdout
