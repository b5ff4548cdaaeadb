"""BENCHMARK.json against the contract, and every name resolving to its file."""
from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from perfbench.harness import bench, deploy, result, roofline
from perfbench.harness.trace import Trace

BENCH = bench.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = bench.resolve(name)
    assert cell.chips == 1
    assert bench.driver(cell).__name__.endswith(cell.traffic["driver"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(bench.metric_reader(m["name"]))
        assert m["moves"] in reported


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(config):
    data = json.loads((bench.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert key in data and key in data["assumed"]


def test_tahoe_config_is_the_ports_testbed_and_catalog():
    from repro_torch.storage.cluster import tahoe_testbed

    cfg = bench.resolve("tahoe-3dc.read-degraded").config
    testbed = tahoe_testbed(device="cpu")
    got = [(n["name"], n["site"], n["overhead_s"], n["bandwidth_mbps"], n["cost"])
           for n in deploy.nodes(cfg)]
    assert got == [(n.name, n.site, n.overhead_s, n.bandwidth_mbps, n.cost_per_chunk)
                   for n in testbed.nodes]
    k, lam = deploy.catalog(cfg)
    assert k.tolist()[:8] == [6, 7, 6, 4, 6, 7, 6, 4] and k.shape == (1000,)
    assert lam[2] == np.float32(1.25 / 12000) and abs(lam.sum() - 0.118) < 1e-3
    assert np.bincount(k[:cfg["resident"]] % 4 == 0).sum() == 128  # files 0..127
    assert [int((np.arange(128) % 4 == q).sum()) for q in range(4)] == [32] * 4


def test_hdfs_config_is_homogeneous_fig6_with_rack_spread():
    from repro_torch.storage.cluster import homogeneous_cluster

    cfg = bench.resolve("hdfs-rs-6-3.ingest").config
    ref = homogeneous_cluster(18, device="cpu")
    assert [n["bandwidth_mbps"] for n in deploy.nodes(cfg)] == [n.bandwidth_mbps
                                                                  for n in ref.nodes]
    mask = deploy.placement_mask(cfg["plan"]["placement"], 36, 18)
    assert (mask.sum(1) == 9).all()
    per_rack = mask.reshape(36, 6, 3).sum(-1)
    assert per_rack.max() == 2 and per_rack.min() == 1
    assert cfg["catalog"]["file_bytes"] == 6 * 128 * 2**20


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    line = json.loads(result.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
        compared={"bad": (0, 0)},
        breakdown={"device_ops": [], "idle_gaps": []} if traced else None))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["compared"]
    assert line["compared"] == {"bad": {"value": 0, "limit": 0}}


def test_result_line_refuses_a_number_that_is_not_finite():
    with pytest.raises(ValueError):
        result.result_line(correct=True, attempted=1, failed=0,
                           metrics={"x": {"value": float("inf"), "unit": "ms"}},
                           device={}, compared={})


def test_roofline_bytes_are_the_kernel_formulas():
    # PERF.md section 6: B1 S N (8 + 5 m) + 16 S m; B2 / B3 B (M K + K N + M N)
    assert roofline.fcfs_scan_bytes(256, 100_000, 12) == 256 * 100_000 * 68 + 16 * 256 * 12
    assert round(roofline.fcfs_scan_bytes(256, 100_000, 12) / 1e9, 3) == 1.741
    assert roofline.gf256_bytes(500, 6, 6, 699_051) == 500 * (36 + 2 * 6 * 699_051)
    assert round(roofline.gf256_bytes(500, 6, 6, 699_051) / 1e9, 3) == 4.194
    assert round(roofline.gf256_bytes(1, 6, 6, 349_525_500) / 1e9, 3) == 4.194
    assert roofline.decode_bytes(6, 100) == 1200 and roofline.encode_bytes(9, 6, 100) == 1500
    assert roofline.share(3.35e12, 2.0, "NVIDIA H100 80GB HBM3") == 50.0
    assert roofline.share(1.0, 1.0, "some other card") is None
    assert roofline.share(0, 1.0, "NVIDIA H100 80GB HBM3") is None


def test_trace_reduction_on_a_made_up_window():
    ev = [
        {"cat": "user_annotation", "name": "window", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "decode_requests", "ts": 10, "dur": 20},
        {"cat": "user_annotation", "name": "fetch", "ts": 40, "dur": 30},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 45, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "void gf256_matmul_kernel<6>(Params)", "ts": 20, "dur": 30,
         "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 60, "dur": 10,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "outside", "ts": 150, "dur": 10, "args": {"correlation": 3}},
    ]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(40e-6)
    assert t.device_s_under("decode_requests") == pytest.approx(30e-6)
    assert t.device_s_under("fetch") == pytest.approx(10e-6)
    assert t.kernel_s("gf256_matmul_kernel") == (pytest.approx(30e-6), 1)
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("void gf256")
    gaps = dict(b["idle_gaps"])
    assert gaps["harness"] == pytest.approx(20e-6 + 30e-6)  # before 20 and after 70
    assert gaps["fetch"] == pytest.approx(10e-6)  # 50..60, fetch open at 50


def test_payloads_are_reproducible_from_the_seed():
    from perfbench.harness.common import derive, payload

    a = payload((3, 50), torch.device("cpu"), 2**40 + 3, "file", 7)
    assert torch.equal(a, payload((3, 50), torch.device("cpu"), 2**40 + 3, "file", 7))
    assert not torch.equal(a, payload((3, 50), torch.device("cpu"), 2**40 + 3, "file", 8))
    assert derive(2**70, "x") != derive(2**70, "y") and derive(5, "x") < 2**63


def test_a_driver_that_is_not_there_is_refused():
    cell = bench.resolve(CELLS[0])
    for name in ("no_such_driver", "../run", "reads.x"):
        with pytest.raises(ImportError):
            bench.driver(dataclasses.replace(cell, traffic=dict(cell.traffic, driver=name)))


@pytest.mark.parametrize("name", CELLS)
def test_each_driver_declares_its_kernel_control_and_faults(name):
    from perfbench.harness.system import FAULTS, System

    drv = bench.driver(bench.resolve(name))
    assert drv.KERNEL in ("gf256_matmul", "fcfs_queue")
    assert isinstance(drv.control(), System) and drv.control() != System()
    for fault in FAULTS:
        assert isinstance(drv.fault(fault), System) and drv.fault(fault) != System()


def test_the_sampled_reads_hold_every_code():
    from types import SimpleNamespace

    from perfbench.harness import reads

    k = np.array([6, 7, 6, 4] * 8)
    files = np.array([0] * 200 + [1, 3])  # two reads off the common code
    st = SimpleNamespace(seed=2**40 + 1, sched=SimpleNamespace(files=files),
                         cell=SimpleNamespace(traffic=dict(sample_reads=4,
                                                           sample_reads_per_code=2)),
                         dep=SimpleNamespace(k=k, plan=SimpleNamespace(n=np.full(32, 12))))
    got = reads.sample_reads(st)
    assert len(got) == 4 and len(set(got.tolist())) == 4
    assert sorted(k[files[got]].tolist()) == [4, 6, 6, 7]
