"""The benchmark of the PyTorch / CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json` once and prints one JSON line.
Everything a cell needs is found by name: its configuration under
`configs/`, its traffic mix under `traffic/` (data read by one of the
general drivers in `harness/`), and each per-layer metric as a reader of its
own under `metrics/`. The plain reference that decides `correct` lives under
`reference/` and imports nothing of the port.
"""
