"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro/launch/roofline.py``, and its dispatch counter.

* The pure functions, held exactly to the reference's on all 10 archs x 4
  shapes x both production meshes' shapes: ``model_flops``,
  ``rwkv_inner_correction``, ``flash_io_bytes``,
  ``attention_hbm_adjustment``, ``moe_cpu_excess``, ``extrapolate``, and
  the dry-run's ``_unrolled_cfg`` and ``_active_params``.
* ``CellCosts.roofline`` equals the reference's formula with the
  reference's constants set, in the test, to the port's H100 constants
  and all collective bytes on one axis (a link inside a node, or across).
* ``CostCounter``: its FLOPs on SmolLM's smoke config equal an analytic
  count of the config's products (a forward, and a train step's 3x); on a
  fake (4, 2) mesh it counts per device (a replicated product in full, a
  sharded one 1/n), its collectives by mesh axis; a WKV step shows it the
  one product ``rwkv_counter_misses`` assumes, and the dry-run's stand-in
  for the token loop none, on each rank's block as the loop runs.

The reference's ``dryrun.py`` fakes 512 host devices through
``XLA_FLAGS`` when imported; the tests import it with ``XLA_FLAGS`` set
(to the worker's own value), so nothing changes for later tests.
"""
import dataclasses
import importlib
import os

import pytest
import torch
import torch.distributed as dist

import repro.launch.roofline as ref_rl
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_config as ref_config
from repro.models import SHAPES as REF_SHAPES
import repro_torch.launch.roofline as rl
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.models import SHAPES, Model
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
CHIPS = {"single": 256, "multi": 512}


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module, imported with XLA_FLAGS already set,
    so its ``os.environ.setdefault`` fakes no devices for this worker."""
    before = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = before or ""
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            del os.environ["XLA_FLAGS"]


def test_arch_and_shape_registries_match():
    assert tuple(ARCHS) == tuple(REF_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pure_functions_equal_the_reference(arch, mesh):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    ms, chips = MESHES[mesh], CHIPS[mesh]
    for name in SHAPES:
        shape, ref_shape = SHAPES[name], REF_SHAPES[name]
        assert rl.model_flops(cfg, shape, 123_456_789, 987_654_321) == ref_rl.model_flops(
            ref_cfg, ref_shape, 123_456_789, 987_654_321)
        assert rl.rwkv_inner_correction(cfg, shape, chips) == ref_rl.rwkv_inner_correction(
            ref_cfg, ref_shape, chips)
        for fn in ("flash_io_bytes", "attention_hbm_adjustment", "moe_cpu_excess"):
            assert getattr(rl, fn)(cfg, shape, dict(ms)) == getattr(ref_rl, fn)(
                ref_cfg, ref_shape, dict(ms)), (fn, name)


def test_extrapolate_equals_the_reference():
    a = dict(flops=1.5e12, bytes_accessed=3.25e11, collective_bytes=7.0e9,
             peak_memory_bytes=4.0e10, fused_bytes=1.0e11)
    b = dict(flops=2.75e12, bytes_accessed=6.0e11, collective_bytes=1.3e10,
             peak_memory_bytes=5.0e10, fused_bytes=1.5e11)
    want = ref_rl.extrapolate(ref_rl.CellCosts(**a), ref_rl.CellCosts(**b), 29)
    got = rl.extrapolate(rl.CellCosts(**a, collective_by_axis={"model": a["collective_bytes"]}),
                         rl.CellCosts(**b, collective_by_axis={"model": b["collective_bytes"]}),
                         29)
    for key in a:
        assert getattr(got, key) == getattr(want, key), key
    assert got.collective_by_axis == {"model": want.collective_bytes}


def test_unrolled_cfg_and_active_params_equal_the_reference(ref_dryrun):
    from repro_torch.launch import dryrun

    for arch in ARCHS:
        cfg, ref_cfg = get_config(arch), ref_config(arch)
        for k in (1, 2, 3):
            got, want = dryrun._unrolled_cfg(cfg, k), ref_dryrun._unrolled_cfg(ref_cfg, k)
            assert (got.n_layers, got.layer_kinds, got.n_periods) == (
                want.n_layers, want.layer_kinds, want.n_periods)
    for arch in ARCHS:  # smoke sizes: the reference traces its init
        assert dryrun._active_params(get_smoke_config(arch)) == ref_dryrun._active_params(
            importlib.import_module("repro.configs.registry").get_smoke_config(arch))


@pytest.mark.parametrize("intra", [True, False], ids=["nvlink", "infiniband"])
def test_cell_roofline_is_the_reference_formula_on_h100_constants(monkeypatch, intra):
    bw = rl.NVLINK_BW if intra else rl.IB_BW
    monkeypatch.setattr(ref_rl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(ref_rl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(ref_rl, "ICI_BW", bw)
    monkeypatch.setattr(ref_rl, "ICI_LINKS", 1)
    for flops, fused, coll in ((3.1e14, 2.0e11, 4.0e9), (1e12, 9.0e11, 1e9), (1e9, 1e8, 3e10)):
        kw = dict(flops=flops, bytes_accessed=5.5 * fused, collective_bytes=coll,
                  fused_bytes=fused)
        want = ref_rl.CellCosts(**kw).roofline(256)
        got = rl.CellCosts(**kw, collective_by_axis={"model": coll},
                           intra_node_axes=("model",) if intra else ()).roofline(256)
        assert got == want
    assert rl.PEAK_FLOPS == rl.peak_flops("bfloat16") == 989.4e12
    assert rl.peak_flops("float32") < rl.peak_flops("tf32") < rl.PEAK_FLOPS


# ------------------------------------------------------------- counter
def _smollm_products(cfg, b: int, t: int) -> float:
    """The forward's products: projections, the naive attention's two
    batched products over every (query, key) pair, the MLP and the head."""
    d, h, kh, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
                           cfg.vocab)
    per_layer = 2 * b * t * d * (h + 2 * kh) * hd + 2 * b * t * h * hd * d
    per_layer += 2 * (2 * b * h * t * t * hd)
    per_layer += 3 * 2 * b * t * d * ff
    return cfg.n_layers * per_layer + 2 * b * t * d * v


def test_counter_flops_equal_the_smoke_configs_products():
    from repro_torch.launch.steps import loss_and_grads

    cfg = get_smoke_config("smollm-135m")
    model = Model(cfg=cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b, t = 2, 24
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=torch.Generator())}
    with rl.CostCounter() as counter:
        model.forward_logits(params, batch)
    assert counter.flops == _smollm_products(cfg, b, t)
    with rl.CostCounter() as counter:
        loss_and_grads(model, params, batch)
    assert counter.flops == 3 * _smollm_products(cfg, b, t)
    costs = counter.costs()
    assert costs.collective_bytes == 0 and costs.peak_memory_bytes > 0
    assert 0 < costs.fused_bytes < costs.bytes_accessed


def test_counter_counts_the_wkv_steps_one_product():
    from repro_torch.models import rwkv6

    b, t, h, hd = 2, 5, 3, 8
    g = torch.Generator().manual_seed(1)
    r, k, v, w = (torch.randn((b, t, h, hd), generator=g) for _ in range(4))
    u = torch.randn((h, hd), generator=g)
    state = torch.zeros((b, h, hd, hd))
    with rl.CostCounter() as counter:
        rwkv6._wkv_scan(r, k, v, w, u, state)
    assert counter.flops == 2 * b * t * h * hd * hd
    # the dry-run's stand-in: the loop's outputs, no product
    from repro_torch.launch.dryrun import _wkv_io_only

    with rl.CostCounter() as counter:
        got = _wkv_io_only(r, k, v, w, u, state)
    want = rwkv6._wkv_scan(r, k, v, w, u, state)
    assert counter.flops == 0 and counter.fused_bytes > 0  # its sums' outputs only
    assert [(x.shape, x.dtype) for x in got] == [(x.shape, x.dtype) for x in want]
    cfg = dataclasses.replace(get_smoke_config("rwkv6-1.6b"), d_model=h * hd,
                              rwkv_head_size=hd, n_layers=1, period=("rwkv",))
    n = b * t * h * hd * hd
    for kind, misses in (("prefill", 8 * n), ("train", 24 * n), ("decode", 6 * n // t)):
        shape = SHAPES["train_4k"].__class__("t", t, b, kind)
        assert rl.rwkv_counter_misses(cfg, shape, {}) == misses, kind


def test_wkv_stand_in_plus_its_count_is_the_loops_count(fake_world_8):
    """A dry-run prefill of RWKV6's smoke config on a fake (4, 2) mesh with
    the stand-in, against the same with the real loop: the counts differ by
    the loop's one product a step on each rank's (batch, head) block, which
    is what ``rwkv_counter_misses`` takes the counter to see."""
    import repro_torch.launch.dryrun as dr
    from repro_torch.models import rwkv6

    cfg = get_smoke_config("rwkv6-1.6b")
    mesh = dr.make_mesh("4x2")
    shape = dr.parse_shape("prefill:8x12")
    stand_in, _ = dr.cell_costs(cfg, shape, mesh)
    real_loop = rwkv6._wkv_scan
    dr._wkv_io_only, saved = real_loop, dr._wkv_io_only
    try:
        looped, _ = dr.cell_costs(cfg, shape, mesh)
    finally:
        dr._wkv_io_only = saved
    ms = {"data": 4, "model": 2}
    b, t, h, hd = rl._wkv_local(cfg, shape, ms)
    n_rwkv = sum(k == "rwkv" for k in cfg.layer_kinds)
    assert (b, t) == (2, 12) and h == cfg.d_model // hd // 2
    assert looped.flops - stand_in.flops == 2 * n_rwkv * b * t * h * hd * hd
    assert rl.rwkv_counter_misses(cfg, shape, ms) == 4 * (looped.flops - stand_in.flops)
    assert rl.wkv_io_bytes(cfg, shape, ms) > 0


@pytest.fixture
def fake_world_8():
    from repro_torch.launch.dryrun import fake_world

    fake_world(8)
    yield
    dist.destroy_process_group()


def test_counter_is_per_device_on_a_fake_mesh(fake_world_8):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import make_mesh

    mesh = make_mesh("4x2")
    counter = rl.CostCounter(mesh)
    assert set(counter.groups.values()) == {"data", "model"}
    assert counter.intra == ("data", "model")  # 8 ranks: one node
    with FakeTensorMode(), counter:
        x = DTensor.from_local(torch.empty(2, 16), mesh, [Shard(0), Replicate()],
                               run_check=False)  # (8, 16), rows over data
        w_rep = DTensor.from_local(torch.empty(16, 6), mesh, [Replicate(), Replicate()],
                                   run_check=False)
        w_col = DTensor.from_local(torch.empty(16, 3), mesh, [Replicate(), Shard(1)],
                                   run_check=False)  # (16, 6), columns over model
        x @ w_rep  # each rank: its 2 rows in full
        f1 = counter.flops
        y = x @ w_col  # each rank: its 2 rows x its 3 columns
        f2 = counter.flops - f1
        y.redistribute(mesh, [Replicate(), Replicate()])
    assert f1 == 2 * 2 * 16 * 6
    assert f2 == 2 * 2 * 16 * 3 == f1 / 2
    costs = counter.costs()
    # all-gathers (payload: what comes out): the (2, 3) blocks to (2, 6) over
    # model, then those to (8, 6) over data
    assert costs.collective_by_axis == {"model": 2 * 6 * 4.0, "data": 8 * 6 * 4.0}
    assert costs.roofline(8)["collective_s"] == costs.collective_bytes / rl.NVLINK_BW


def test_mesh_groups_on_the_production_mesh():
    from repro_torch.launch.dryrun import make_mesh

    try:
        mesh = make_mesh("single")
        labels, intra = rl.mesh_groups(mesh)
        assert set(labels.values()) == {"data", "model"} and intra == ()
        mesh = make_mesh("multi")
        labels, intra = rl.mesh_groups(mesh)
        assert set(labels.values()) == {"pod", "data", "model", "pod,data"} and intra == ()
    finally:
        dist.destroy_process_group()
