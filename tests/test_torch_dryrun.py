"""The dry-run (``repro_torch.launch.dryrun``) at smoke size, the ``stub``
attention probe and the MoE's static-shape path, on the CPU.

* The mini dry-run: SmolLM's and Qwen3-MoE's smoke configs on a fake
  (4, 2) world, train / prefill / decode at O0 and O2 (Qwen3-MoE's EP
  island on its tiny and its ZeRO path), each cell ``ok`` with the
  reference's record keys; the count is linear in periods (what the
  reference's ``extrapolate`` relies on) and ``extrapolate`` of one and
  two periods gives the three-period count (Qwen3-MoE, a train step).
* The stub's prefill: logits and caches equal the reference's
  ``attn_impl="stub"`` on smoke configs with attention (SmolLM, Gemma3's
  local layers) and MLA (DeepSeek-V3), at atol 1e-5.
* The static MoE path equals the loop path on real tensors at atol 1e-6
  and runs under ``FakeTensorMode``, where the loop cannot; what it counts
  beyond the grouped product (``moe_cpu_excess``'s FLOPs,
  ``moe_static_excess_bytes``' fused and live bytes) is what a grouped
  product with its rows dealt evenly over the experts counts less.
"""
import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import moe
from test_torch_archs import _batch, _close, _jax, _pair, _torch, _tree_close
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KEYS = {"arch", "shape", "mesh", "opt", "compile_s", "memory_analysis", "per_device_bytes",
        "fits_h100_80g", "raw", "corrected", "moe_cpu_excess_flops", "flash_io_bytes",
        "roofline", "model_flops", "active_params", "total_params_nonemb",
        "useful_flops_ratio", "roofline_fraction", "status", "per_device_bytes_static",
        "moe_static_excess_bytes"}


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
]


@pytest.mark.parametrize("arch,shape,opt", CELLS)
def test_mini_dry_run_reports_ok(fake_world, arch, shape, opt):
    zero = shape == "train:8x2048"  # the path's count alone (one run, not two)
    rec = dryrun.run_cell(arch, shape, "4x2", with_roofline=not zero, opt=opt, smoke=True)
    assert rec["status"] == "ok" and rec["fits_h100_80g"]
    raw = rec["raw"]
    assert raw["flops"] > 0 and set(raw["collective_by_axis"]) <= {"data", "model"}
    assert tuple(raw["intra_node_axes"]) == ("data", "model")
    if zero:
        return
    assert KEYS <= set(rec)
    r = rec["roofline"]
    assert r["bound_step_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"]) > 0
    assert rec["per_device_bytes"] >= rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert (rec["moe_cpu_excess_flops"] > 0) == (arch == "qwen3-moe-30b-a3b")
    moe_bytes = rec["moe_static_excess_bytes"]
    assert (moe_bytes["fused"] > 0) == (arch == "qwen3-moe-30b-a3b")
    assert rec["per_device_bytes"] == rec["per_device_bytes_static"] - moe_bytes["live"]
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
    """``moe._expert_compute`` with the rows dealt evenly over the local
    experts: sizes known without values, so it runs on fake tensors."""
    n, rows = w_gate.shape[0], x_sorted.shape[0]
    sizes = [rows // n + (e < rows % n) for e in range(n)]
    gates, ups, downs = torch.unbind(w_gate), torch.unbind(w_up), torch.unbind(w_down)
    return torch.cat([(F.silu(r @ gates[e]) * (r @ ups[e])) @ downs[e]
                      for e, r in enumerate(torch.split(x_sorted, sizes))])


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-moe-30b-a3b", "train:8x2048"),  # the island's ZeRO path
    ("qwen3-moe-30b-a3b", "decode:8x64"),  # its tiny path
    ("deepseek-v3-671b", "train:8x64"),
])
def test_moe_static_excess_is_what_the_static_path_adds(fake_world, monkeypatch, arch, shape):
    cfg = get_smoke_config(arch)
    mesh = dryrun.make_mesh("4x2")
    sh = dryrun.parse_shape(shape)
    ms = dict(zip(mesh.mesh_dim_names, mesh.shape))
    static = dryrun.cell_costs(cfg, sh, mesh, "O0")[0]
    rows = []

    def grouped(x_sorted, *args):
        rows.append(x_sorted.shape[0])
        return _grouped_even(x_sorted, *args)

    monkeypatch.setattr(moe, "_expert_compute_static", grouped)
    even = dryrun.cell_costs(cfg, sh, mesh, "O0")[0]
    fused, live = roofline.moe_static_excess_bytes(cfg, sh, ms)
    assert static.flops - roofline.moe_cpu_excess(cfg, sh, ms) == even.flops
    # the grouped product's own combine, a cat of rows x d, counted three
    # times a layer in a train step and once in decode
    train = sh.kind == "train"
    n_moe = sum(k in ("moe", "mla") for k in cfg.layer_kinds)
    combine = n_moe * rows[0] * cfg.d_model * 2 * (3 if train else 1)
    assert static.fused_bytes - fused == even.fused_bytes - combine > 0
    assert (live > 0) == train
    # the extra experts' saved outputs are all live at Qwen3-MoE's peak; at
    # DeepSeek's some have been freed, and removing them all undercounts
    assert static.peak_memory_bytes - live <= even.peak_memory_bytes <= static.peak_memory_bytes
    if arch.startswith("qwen3"):
        assert static.peak_memory_bytes - live == even.peak_memory_bytes
