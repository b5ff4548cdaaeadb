"""Resolve a cell of `BENCHMARK.json` to its files, by name.

A cell names a configuration and a traffic mix. The configuration's file is
the one `BENCHMARK.json` gives; the traffic mix is `traffic/<traffic>.json`,
whose `driver` names a general driver, the module `harness/<driver>.py`
(`setup`, `window`, `check`, its `KERNEL` library, its `control()` and
`fault(name)`); each per-layer metric is `metrics/<name>.py`, a module with
a `read(ctx)`.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"
DRIVER_NAME = re.compile(r"^[a-z_][a-z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple[dict, ...]  # the cell's end-to-end metrics, setup_s included
    per_layer: tuple[dict, ...]  # the cell's per-layer metrics


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics loaded."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _in_cell(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _in_cell(m, name)),
    )


def driver(cell: Cell):
    """The general driver module the cell's traffic names, `harness/<driver>.py`."""
    name = str(cell.traffic.get("driver"))
    path = BENCH_DIR / "harness" / f"{name}.py"
    if not DRIVER_NAME.match(name) or not path.exists():
        raise ImportError(f"traffic {cell.traffic_name!r} names driver {name!r}, "
                          f"and there is no {path}")
    return importlib.import_module(f"perfbench.harness.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of `metrics/<name>.py`, loaded by path (names hold dots)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
