"""Reduce a `torch.profiler` chrome trace of the measured window.

Device events are kernels, copies and fills; each carries the correlation
id of the runtime call that launched it, whose host timestamp places it
under the harness span that was open then. The window is the harness's
`window` span: the loop of the measured window, its drain and its last
synchronisation, so all of its device work ends inside it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "window"


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """The window's device events, host spans and launch times (µs)."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
        windows = [e for e in spans if e["name"] == WINDOW]
        if not windows:
            raise ValueError("the trace holds no 'window' span")
        w = max(windows, key=lambda e: e["dur"])
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = float(e["ts"])
        self.device = []  # (start, end, name, launch ts or None)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            start = float(e["ts"])
            end = start + float(e["dur"])
            if end <= self.start or start >= self.end:
                continue
            corr = e.get("args", {}).get("correlation")
            self.device.append((max(start, self.start), min(end, self.end), e["name"],
                                launch.get(corr)))
        self.spans = defaultdict(list)
        for e in spans:
            if e["name"] != WINDOW:
                self.spans[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for name in self.spans:
            self.spans[name].sort()
        self.busy = _merge([(s, e) for s, e, _, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def _covering(self, name: str, ts: float | None) -> bool:
        if ts is None:
            return False
        spans = self.spans.get(name, [])
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def device_s_under(self, name: str) -> float:
        """Device seconds of the work launched inside spans ``name``."""
        return sum(e - s for s, e, _, ts in self.device if self._covering(name, ts)) * 1e-6

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name holds ``fragment``."""
        hits = [e - s for s, e, n, _ in self.device if fragment in n]
        return sum(hits) * 1e-6, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost harness span open when each began."""
        ops = defaultdict(float)
        for s, e, n, _ in self.device:
            ops[n] += (e - s) * 1e-6
        flat = sorted((s, e, n) for n, v in self.spans.items() for s, e in v)
        starts = [s for s, _, _ in flat]
        gaps = defaultdict(float)
        edges = [self.start] + [x for b in self.busy for x in b] + [self.end]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            i = bisect.bisect_right(starts, g0) - 1
            owner = "harness"  # between the harness's spans
            # spans nest at most a few deep: look back only that far
            for j in range(i, max(i - 4, -1), -1):
                if flat[j][1] > g0:
                    owner = flat[j][2]
                    break
            gaps[owner] += (g1 - g0) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
