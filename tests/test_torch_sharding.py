"""The port's sharding rules (``repro_torch.distributed.sharding``) and
meshes against the reference's, with no ranks.

* Parity: ``spec_for_leaf`` for every parameter leaf of all ten archs,
  smoke and full configs, on the (4, 2), (16, 16) and (2, 16, 16) meshes:
  the reference's on ``AbstractMesh`` over ``jax.eval_shape(model.init)``,
  the port's on ``MeshShape`` over the ``meta`` init. The same for
  ``batch_specs`` of every arch at every ``SHAPES`` entry and for
  ``cache_spec_for_leaf`` over every arch's decode caches.
* The reference's own asserted cases (``tests/test_distributed.py``'s
  ``TestShardingRules``, which cannot be collected under JAX 0.9.0).
* Placements: one per mesh dim, a dim over ("pod", "data") sharded with pod
  as the major index (JAX's order), checked by each rank's local shard and
  offset on a 512-rank ``DeviceMesh`` over a fake process group.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.distributed.sharding as RSH
import repro.launch.specs as RSP
import repro.launch.steps as RS
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke_config
import repro_torch.launch.specs as PSP
import repro_torch.launch.steps as PS
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.distributed.sharding import (
    MeshShape,
    P,
    batch_specs,
    cache_spec_for_leaf,
    mesh_axes,
    placements,
    spec_for_leaf,
)
from repro_torch.models import SHAPES
from repro_torch.optim import AdamW
from repro_torch.tree import flatten_with_keys
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "1pod": ((16, 16), ("data", "model")),
    "2pod": ((2, 16, 16), ("pod", "data", "model")),
}
MESH_1POD = MeshShape(("data", "model"), (16, 16))
MESH_2POD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def _meshes():
    return [(AbstractMesh(sizes, names), MeshShape(names, sizes))
            for sizes, names in MESHES.values()]


def _same(port: P, ref) -> None:
    assert isinstance(port, P) and tuple(port) == tuple(ref), (port, ref)


def _models(arch: str, smoke: bool):
    cfg = (ref_smoke_config if smoke else ref_config)(arch)
    ref = RS.build_model(cfg, None, dtype=jnp.bfloat16)
    port = PS.build_model((get_smoke_config if smoke else get_config)(arch), None,
                          dtype=torch.bfloat16, device="cpu")
    return ref, port


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, smoke):
    ref, port = _models(arch, smoke)
    ref_leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(ref.init,
                                                                     jax.random.key(0)))[0]
    port_leaves = dict(flatten_with_keys(PS.abstract_train_state(port, AdamW()).params))
    assert {jax.tree_util.keystr(p) for p, _ in ref_leaves} == set(port_leaves)
    for ref_mesh, mesh in _meshes():
        for path, leaf in ref_leaves:
            key = jax.tree_util.keystr(path)
            assert tuple(port_leaves[key].shape) == leaf.shape, key
            _same(spec_for_leaf(key, port_leaves[key], mesh),
                  RSH.spec_for_leaf(path, leaf, ref_mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    """Every ``SHAPES`` entry's batch (``(3, B, S)`` positions included) and
    every decode shape's caches, full config, on every mesh."""
    cfg, port_cfg = ref_config(arch), get_config(arch)
    ref, port = _models(arch, smoke=False)
    for shape in SHAPES.values():
        want = RSP.batch_specs_for(cfg, shape)
        got = PSP.batch_specs_for(port_cfg, shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        for ref_mesh, mesh in _meshes():
            want_specs, got_specs = RSH.batch_specs(want, ref_mesh), batch_specs(got, mesh)
            assert want_specs.keys() == got_specs.keys()
            for k in want_specs:
                _same(got_specs[k], want_specs[k])
        if shape.kind != "decode" or not RSP.cell_is_runnable(arch, shape.name)[0]:
            assert PSP.cell_is_runnable(arch, shape.name) == RSP.cell_is_runnable(
                arch, shape.name)
            continue
        ref_caches = jax.tree_util.tree_flatten_with_path(RSP.cache_specs(ref, shape))[0]
        port_caches = dict(flatten_with_keys(PSP.cache_specs(port, shape)))
        assert {jax.tree_util.keystr(p) for p, _ in ref_caches} == set(port_caches)
        for ref_mesh, mesh in _meshes():
            for path, leaf in ref_caches:
                key = jax.tree_util.keystr(path)
                assert tuple(port_caches[key].shape) == leaf.shape, key
                _same(cache_spec_for_leaf(key, port_caches[key], mesh),
                      RSH.cache_spec_for_leaf(path, leaf, ref_mesh))


# ---------------------------------------- the reference's asserted cases


def _spec(names, shape, mesh) -> P:
    key = "".join(f"[{n!r}]" for n in names)
    return spec_for_leaf(key, torch.empty(shape, device="meta"), mesh)


class TestShardingRules:
    def test_mlp_tp_fsdp(self):
        s = _spec(["stack", "period", "mlp", "w_gate"], (6144, 24576), MESH_1POD)
        assert s == P("data", "model")

    def test_multi_pod_fsdp_spans_pod_and_data(self):
        s = _spec(["stack", "mlp", "w_gate"], (6144, 24576), MESH_2POD)
        assert s == P(("pod", "data"), "model")

    def test_stacked_period_params_get_leading_none(self):
        s = _spec(["stack", "period", "attn", "wq"], (10, 5376, 4096), MESH_1POD)
        assert s == P(None, "data", "model")

    def test_indivisible_heads_fall_back(self):
        # 90 columns cannot split 16-way tp -> tp dropped (trailing trim)
        s = _spec(["attn", "wq"], (128, 90), MESH_1POD)
        assert s == P("data")

    def test_indivisible_fsdp_partially_drops(self):
        # 24 % (pod*data=32) != 0 but 24 % pod=2 == 0 -> keep only 'pod'
        s = _spec(["attn", "wq"], (24, 90), MESH_2POD)
        assert s == P("pod")

    def test_moe_expert_rules_match_epspec(self):
        s = _spec(["moe", "w_gate"], (128, 2048, 768), MESH_1POD)
        assert s == P("model", None, "data")
        s = _spec(["moe", "w_down"], (128, 768, 2048), MESH_1POD)
        assert s == P("model", "data")  # trailing None trimmed
        s = _spec(["moe", "shared", "w_gate"], (7168, 2048), MESH_1POD)
        assert s == P(None, "model")

    def test_router_replicated(self):
        assert _spec(["moe", "router"], (2048, 128), MESH_1POD) == P()

    def test_embed(self):
        s = _spec(["embed"], (262144, 5376), MESH_1POD)
        assert s == P("model", "data")

    def test_mesh_axes(self):
        assert mesh_axes(MESH_1POD)["dp"] == ("data",)
        assert mesh_axes(MESH_2POD)["dp"] == ("pod", "data")


# ---------------------------------------------------------- placements


def test_placements_one_per_mesh_dim_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    assert placements(P(("pod", "data"), "model"), MESH_2POD) == (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), MESH_2POD) == (Replicate(), Shard(1), Replicate())
    assert placements(P(), MESH_1POD) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), MESH_2POD)


@pytest.fixture
def fake_world(request):
    """A default group of ``request.param`` = (world size, rank) in this
    process (its collectives do nothing); destroyed afterwards."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world, rank = request.param
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("fake_world", [(512, 1 * 256 + 3 * 16 + 5)], indirect=True)
def test_two_pod_mesh_shards_in_jax_order(fake_world):
    """Rank (pod 1, data 3, model 5) of the (2, 16, 16) mesh holds block
    1 * 16 + 3 of a dim split over ("pod", "data"), as JAX's major-to-minor
    P(("pod", "data")) places it."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 16, 16)
    assert [mesh.get_local_rank(a) for a in ("pod", "data", "model")] == [1, 3, 5]
    spec = _spec(["stack", "mlp", "w_gate"], (6144, 24576), mesh)
    assert spec == P(("pod", "data"), "model")
    shape, offset = compute_local_shape_and_global_offset((6144, 24576), mesh,
                                                          placements(spec, mesh))
    assert tuple(shape) == (6144 // 32, 24576 // 16)
    assert tuple(offset) == ((1 * 16 + 3) * 192, 5 * 1536)


@pytest.mark.parametrize("fake_world", [(256, 3 * 16 + 5)], indirect=True)
def test_one_pod_mesh_shards_by_the_rules(fake_world):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
    spec = _spec(["embed"], (262144, 5376), mesh)
    assert spec == P("model", "data")
    shape, offset = compute_local_shape_and_global_offset((262144, 5376), mesh,
                                                          placements(spec, mesh))
    assert tuple(shape) == (262144 // 16, 5376 // 16)
    assert tuple(offset) == (5 * (262144 // 16), 3 * (5376 // 16))
