"""The result line and the compared numbers printed beside their limits."""
from __future__ import annotations

import json
import math


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                compared: dict, breakdown: dict | None = None) -> str:
    """One JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`,
    `breakdown` when the run was traced, and the compared numbers last."""
    for name, metric in metrics.items():
        if not math.isfinite(metric["value"]):
            raise ValueError(f"metric {name} is not a finite number: {metric['value']}")
    line = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
                metrics=metrics, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {name: {"value": v, "limit": lim} for name, (v, lim) in compared.items()}
    return json.dumps(line)


def compared_lines(compared: dict) -> list[str]:
    return [f"compared {name} {value} limit {limit}" for name, (value, limit) in compared.items()]
