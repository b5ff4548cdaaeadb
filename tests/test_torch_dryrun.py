"""The dry-run (``repro_torch.launch.dryrun``) at smoke size, the ``stub``
attention probe and the MoE's static-shape path, on the CPU.

* The mini dry-run: SmolLM's and Qwen3-MoE's smoke configs on a fake
  (4, 2) world, train / prefill / decode at O0 and O2 (Qwen3-MoE's EP
  island on its tiny and its ZeRO path), and Qwen3-MoE's prefill of one
  sequence on a (2, 2) world (a batch narrower than the DP axis: every
  cache keeps batch 1), each cell ``ok`` with the reference's record
  keys; the count is linear in periods (what the reference's
  ``extrapolate`` relies on) and ``extrapolate`` of one and two periods
  gives the three-period count (Qwen3-MoE, a train step).
* The multi-pod mesh: ``make_mesh("PxRxC")`` is ('pod', 'data', 'model'),
  and SmolLM's smoke train cell on a fake (2, 2, 2) world is ``ok`` within
  60 s (416 s before the MLP ran on each rank's block).
* The stub's prefill: logits and caches equal the reference's
  ``attn_impl="stub"`` on smoke configs with attention (SmolLM, Gemma3's
  local layers) and MLA (DeepSeek-V3), at atol 1e-5.
* The static MoE path equals the loop path on real tensors at atol 1e-6
  and runs under ``FakeTensorMode``, where the loop cannot. The dry-run
  counts neither: its stand-in (``dryrun._experts_even``) counts exactly
  what ``moe._expert_compute`` counts over the same rows routed evenly
  (FLOPs, fused bytes, peak), and its FLOPs are the static path's less
  the reference's ``moe_cpu_excess`` within one row a group.
"""
import dataclasses
import functools

import jax
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import moe
from repro_torch.tree import tree_leaves
from test_torch_archs import _batch, _close, _jax, _pair, _torch, _tree_close
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KEYS = {"arch", "shape", "mesh", "opt", "compile_s", "memory_analysis", "per_device_bytes",
        "fits_h100_80g", "raw", "corrected", "moe_cpu_excess_flops", "flash_io_bytes",
        "roofline", "model_flops", "active_params", "total_params_nonemb",
        "useful_flops_ratio", "roofline_fraction", "status"}


@pytest.fixture
def fake_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


CELLS = [
    ("smollm-135m", "train:8x64", "O2"),
    ("smollm-135m", "prefill:8x64", "O2"),
    ("smollm-135m", "decode:8x64", "O0"),
    ("qwen3-moe-30b-a3b", "prefill:8x64", "O0"),  # 2 x 64 x 2 <= 4096: the tiny path
    ("qwen3-moe-30b-a3b", "decode:8x64", "O2"),
    ("qwen3-moe-30b-a3b", "train:8x2048", "O2"),  # 2 x 2048 x 2 > 4096: the ZeRO path
    ("qwen3-moe-30b-a3b", "prefill:1x64", "O0"),  # one sequence over 2 DP ranks
]
MESHES = {"prefill:1x64": "2x2"}  # the others on "4x2"


@pytest.mark.parametrize("arch,shape,opt", CELLS)
def test_mini_dry_run_reports_ok(fake_world, monkeypatch, arch, shape, opt):
    mesh = MESHES.get(shape, "4x2")
    zero = shape == "train:8x2048"  # the path's count alone (one run, not two)
    caches = []
    step = dryrun.jit_prefill_step

    def recording(*args, **kwargs):  # every prefill's caches, as the step returns them
        fn, *rest = step(*args, **kwargs)

        def run(*a):
            out = fn(*a)
            caches.append(out[1])
            return out

        return (run, *rest)

    monkeypatch.setattr(dryrun, "jit_prefill_step", recording)
    rec = dryrun.run_cell(arch, shape, mesh, with_roofline=not zero, opt=opt, smoke=True)
    assert rec["status"] == "ok" and rec["fits_h100_80g"]
    raw = rec["raw"]
    assert raw["flops"] > 0 and set(raw["collective_by_axis"]) <= {"data", "model"}
    assert tuple(raw["intra_node_axes"]) == ("data", "model")
    b = dryrun.parse_shape(shape).global_batch
    for cache in caches:
        assert {leaf.shape[1] for leaf in tree_leaves(cache)} == {b}  # (periods, B, ...)
    assert bool(caches) == shape.startswith("prefill")
    if zero:
        return
    assert KEYS <= set(rec)
    assert not {"per_device_bytes_static", "moe_static_excess_bytes"} & set(rec)
    r = rec["roofline"]
    assert r["bound_step_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
    assert rec["per_device_bytes"] >= rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["per_device_bytes"] == (rec["memory_analysis"]["argument_size_in_bytes"]
                                       + rec["memory_analysis"]["temp_size_in_bytes"])
    # the reference's CPU excess is recorded, not subtracted
    assert (rec["moe_cpu_excess_flops"] > 0) == (arch == "qwen3-moe-30b-a3b")
    corrected = rec["corrected"]
    assert r["compute_s"] == corrected["flops"] / roofline.peak_flops(corrected["dtype"])
    kind = shape.split(":")[0]
    assert (rec["flash_io_bytes"] > 0) == (opt == "O2" and kind != "decode")
    if opt == "O2" and kind != "decode":  # the stub decomposition replaces the twin's tiles
        assert r["memory_s"] < raw["fused_bytes"] / roofline.HBM_BW


def test_count_is_linear_in_periods(fake_world):
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    mesh = dryrun.make_mesh("4x2")
    shape = dryrun.parse_shape("train:8x64")
    c1, c2, c3 = (dryrun.cell_costs(dryrun._unrolled_cfg(cfg, k), shape, mesh, "O0")[0]
                  for k in (1, 2, 3))
    for key in ("flops", "fused_bytes", "bytes_accessed", "collective_bytes"):
        a, b, c = (getattr(x, key) for x in (c1, c2, c3))
        assert c - b == b - a > 0, key
        assert getattr(roofline.extrapolate(c1, c2, 3), key) == c, key
    assert roofline.extrapolate(c1, c2, 3).collective_by_axis == c3.collective_by_axis


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-27b", "deepseek-v3-671b"])
def test_stub_prefill_matches_reference(arch):
    ref, port, ref_params, params = _pair(arch, "O0")
    ref = dataclasses.replace(ref, attn_impl="stub")
    port = dataclasses.replace(port, attn_impl="stub")
    batch = _batch(port.cfg, 20, seed=4)
    want_logits, want_caches = jax.jit(ref.prefill, static_argnames="cache_len")(
        ref_params, _jax(batch), cache_len=24)
    logits, caches = port.prefill(params, _torch(batch), cache_len=24)
    _close(logits, want_logits, atol=1e-5)
    _tree_close(caches, want_caches, 1e-5)
    # the probe changes the core only: the naive model's logits differ
    naive_logits, _ = dataclasses.replace(port, attn_impl="naive").prefill(
        params, _torch(batch), cache_len=24)
    assert not torch.allclose(naive_logits, logits)


def _sorted_rows(seed: int, cap: int, n_local: int, d: int, ff: int):
    g = torch.Generator().manual_seed(seed)
    e_sorted = torch.sort(torch.randint(0, n_local + 1, (cap,), generator=g)).values
    x = torch.randn((cap, d), generator=g)
    w = [torch.randn(shape, generator=g) / shape[1] ** 0.5
         for shape in ((n_local, d, ff), (n_local, d, ff), (n_local, ff, d))]
    return x, e_sorted, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_moe_path_equals_the_loop_on_real_tensors(seed):
    n_local = 4
    x, e_sorted, w = _sorted_rows(seed, 37, n_local, 16, 24)
    sizes = torch.bincount(e_sorted, minlength=n_local + 1)[:n_local]
    want = moe._expert_compute(x, sizes, *w)
    got = moe._expert_compute_static(x, e_sorted, *w)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.equal(got[e_sorted == n_local], torch.zeros_like(got[e_sorted == n_local]))


def test_moe_runs_under_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    with FakeTensorMode():
        p = moe.moe_init(torch.Generator(), cfg, torch.float32, "cpu")
        x = torch.empty((2, 5, cfg.d_model))
        y, aux = moe.moe_apply(p, x, cfg)
        with pytest.raises(Exception):  # the loop's group sizes have no values
            moe._expert_compute(x.reshape(10, -1), torch.empty(8, dtype=torch.int64),
                                p["w_gate"], p["w_up"], p["w_down"])
    assert y.shape == x.shape and aux.shape == ()


def _grouped_even(x_sorted, e_sorted, w_gate, w_up, w_down):
    """``moe._expert_compute`` itself over the rows routed evenly (row i to
    local expert i mod E_local), its group sizes a real tensor made outside
    every mode (the fake mode and the counter), as a card would hold them."""
    from torch.utils._python_dispatch import _disable_current_modes

    n, rows = w_gate.shape[0], x_sorted.shape[0]
    with _disable_current_modes():
        sizes = torch.bincount(torch.arange(rows) % n, minlength=n)
    return moe._expert_compute(x_sorted, sizes, w_gate, w_up, w_down)


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-moe-30b-a3b", "train:8x2048"),  # the island's ZeRO path
    ("qwen3-moe-30b-a3b", "decode:8x64"),  # its tiny path
    ("deepseek-v3-671b", "train:8x64"),
])
def test_dry_run_counts_the_grouped_moe_path(fake_world, monkeypatch, arch, shape):
    """The dry-run's count of a cell (its stand-in ``_experts_even``) equals
    the count with ``moe._expert_compute`` run over the same rows routed
    evenly: FLOPs, fused bytes and the peak, exactly. Its FLOPs are the
    static path's less ``moe_cpu_excess`` within one row a group, and its
    fused bytes and peak no more than the static path's."""
    cfg = get_smoke_config(arch)
    mesh = dryrun.make_mesh("4x2")
    sh = dryrun.parse_shape(shape)
    ms = dict(zip(mesh.mesh_dim_names, mesh.shape))
    calls = []
    stand_in = dryrun._experts_even

    def recording(x_sorted, e_sorted, w_gate, *w):
        calls.append((x_sorted.shape[0], w_gate.shape[0]))
        return stand_in(x_sorted, e_sorted, w_gate, *w)

    monkeypatch.setattr(dryrun, "_experts_even", recording)
    count = dryrun.cell_costs(cfg, sh, mesh, "O0")[0]
    monkeypatch.setattr(dryrun, "_experts_even", _grouped_even)
    grouped = dryrun.cell_costs(cfg, sh, mesh, "O0")[0]
    assert calls and (count.flops, count.fused_bytes, count.peak_memory_bytes) == (
        grouped.flops, grouped.fused_bytes, grouped.peak_memory_bytes)
    monkeypatch.setattr(dryrun, "_experts_even", moe._expert_compute_static)
    static = dryrun.cell_costs(cfg, sh, mesh, "O0")[0]
    # one row a group: a SwiGLU row is 3 products of 2 d ff, thrice in a
    # train step (forward, two backward products each)
    train = sh.kind == "train"
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    row = 6 * d * ff * (3 if train else 1)
    n_groups = sum(n for _, n in calls)
    excess = roofline.moe_cpu_excess(cfg, sh, ms)
    assert abs(static.flops - excess - count.flops) <= n_groups * row
    assert count.fused_bytes < static.fused_bytes and count.flops < static.flops
    assert count.peak_memory_bytes <= static.peak_memory_bytes


def test_make_mesh_takes_pods(fake_world):
    mesh = dryrun.make_mesh("2x1x2")
    assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 1, 2)
    assert dist.get_world_size() == 4
    assert dryrun.make_mesh("2x2").mesh_dim_names == ("data", "model")


def test_multi_pod_train_cell_is_ok_in_a_minute(monkeypatch):
    """SmolLM's smoke train step on a fake (2, 2, 2) ('pod', 'data',
    'model') world through ``_cell``, as the sweep runs it, with the cell's
    time limit cut to 60 s (it took 416 s when the MLP ran op by op under
    DTensor's propagation)."""
    monkeypatch.setattr(dryrun, "CELL_TIMEOUT_S", 60)
    monkeypatch.setattr(dryrun, "run_cell", functools.partial(dryrun.run_cell, smoke=True))
    rec = dryrun._cell(("smollm-135m", "train:4x64", "2x2x2", "O0", False))
    assert rec["status"] == "ok", rec.get("error")
    axes = {a for key in rec["raw"]["collective_by_axis"] for a in key.split(",")}
    assert axes <= {"pod", "data", "model"} and "pod" in axes
    assert not dist.is_initialized()  # the cell ends its fake world
