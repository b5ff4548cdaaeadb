"""One run of one cell: set-up, the measured window, the check, the line.

The traced run (`trace=True`) profiles the window with `torch.profiler`,
reduces the chrome trace (`trace.py`) and hands it, with the spans and the
driver's counters, to each per-layer metric's reader; the untraced run
reports the cell's end-to-end metrics. Either run checks its outputs after
the window has closed and the peak memory has been read.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys

import torch

from . import bench
from .common import Spans, clock, sync
from .system import System
from .trace import Trace

TRACE_FILE = bench.ROOT / "build" / "perfbench" / "trace.json"


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: Trace
    spans: Spans
    counters: dict
    device_kind: str


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    compared: dict
    breakdown: dict | None


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _traced_window(drv, state):
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        win = drv.window(state)
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    del prof
    try:
        events = json.loads(TRACE_FILE.read_text())["traceEvents"]
    finally:
        TRACE_FILE.unlink(missing_ok=True)
    return win, Trace(events)


def run_cell(cell: bench.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, system: System | None = None,
             parts: dict | None = None) -> Outcome:
    parts = {} if parts is None else parts
    drv = bench.driver(cell)
    spans = Spans(annotate=trace)
    state = drv.setup(cell, seed, seconds, device, spans, system or System(), parts)
    sync(device)
    spans.durations.clear()  # the window's spans only, not the warm-up's
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    setup_s = clock() - t_start
    reduced = None
    if trace:
        win, reduced = _traced_window(drv, state)
    else:
        win = drv.window(state)
    gc.unfreeze()
    dev = device_info(device)
    compared = drv.check(state)
    correct = all(value <= limit for value, limit in compared.values())
    metrics, breakdown = {}, None
    if trace:
        ctx = Context(trace=reduced, spans=spans, counters=win["counters"],
                      device_kind=dev["kind"])
        for m in cell.per_layer:
            value = bench.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        breakdown = reduced.breakdown()
    else:
        values = dict(win["values"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    info = dict(win["info"], setup_s=setup_s, setup_parts=parts,
                span_max_ms={name: 1e3 * max(d) for name, d in spans.durations.items() if d})
    if hasattr(state, "near_boundary"):
        info["near_boundary"] = state.near_boundary
    print(json.dumps({"run": info}), file=sys.stderr)
    return Outcome(correct=correct, attempted=win["attempted"], failed=win["failed"],
                   metrics=metrics, device=dev, compared=compared, breakdown=breakdown)
