"""The port's erasure-coded checkpoint planner and store against the
reference, on the CPU.

* ``tests/test_checkpoint.py``'s cases at its sizes, on the port: packing,
  the plan's MDS feasibility and redundancy, theta's cost cut, round trips
  with no failure, with the most failures every group tolerates and with
  one beyond (data loss raises), other read sets decoding the same, the
  elastic replan, and a smoke SmolLM-135M state carried across with
  ``models.convert.params_from_numpy``.
* Against the reference on the same leaves: leaf names and order
  (``keystr``), groups, every ``GroupPlan`` field (pi to the flat-valley
  2e-3 of ``ROADMAP.md`` §C), chunk files and manifests byte for byte, the
  read sets on the reference's uniforms, and each package restoring the
  other's checkpoint bitwise (bfloat16 and a 0-d int32 leaf included).
* SmolLM-135M's full parameter tree (``meta`` tensors, no allocation)
  planned at ``benchmarks/checkpoint_catalogs.py``'s rule, as the
  reference plans it.
* A trainer's whole ``TrainState`` (NamedTuples: ``.params``, ``.opt.step``,
  ``.opt.m[...]``) of the smoke SmolLM after one reference train step:
  leaf names, groups, manifests and chunk files byte for byte the
  reference's, each package restoring the other's checkpoint bitwise into
  its own NamedTuples, and ``params_from_numpy`` keeping an ``AdamWState``.

The store's default ``auto`` backend runs B2's plain twin on CPU tensors;
no test launches a kernel.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
import repro.storage as RS
import repro_torch.checkpoint as PC
import repro_torch.storage as PS
from repro_torch.checkpoint.planner import flatten_with_keys
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PI_ATOL = 2e-3  # flat-valley stops (ROADMAP.md §C)
PLAN_KW = dict(group_mb=0.01, chunk_mb=0.004, theta=0.05)  # tests/test_checkpoint.py


def _to_torch(tree):
    """A reference tree as CPU tensors; bfloat16 leaves through their bits
    (numpy's bfloat16 is not one torch reads)."""
    def leaf(x):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return jax.tree.map(leaf, tree)


def _leaves_equal(got, want):
    got, want = dict(flatten_with_keys(got)), dict(flatten_with_keys(want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g.view(torch.uint8) if g.dim() else g.reshape(1).view(torch.uint8),
                           w.view(torch.uint8) if w.dim() else w.reshape(1).view(torch.uint8)), key


def _ref_leaves_equal(ref_tree, port_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    port = dict(flatten_with_keys(port_tree))
    for path, leaf in flat:
        got = port[jax.tree_util.keystr(path)]
        want = _to_torch(leaf)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


@pytest.fixture(scope="module")
def ref_params():
    key = jax.random.key(0)
    return {
        "embed": jax.random.normal(key, (128, 32)),
        "stack": {
            "w1": jax.random.normal(jax.random.fold_in(key, 1), (32, 64)),
            "w2": (jax.random.normal(jax.random.fold_in(key, 2), (64, 32)) * 0.1).astype(
                jnp.bfloat16),
            "step": jnp.asarray(7, jnp.int32),
        },
    }


@pytest.fixture(scope="module")
def params(ref_params):
    return _to_torch(ref_params)


@pytest.fixture(scope="module")
def clusters():
    return RS.tahoe_testbed(), PS.tahoe_testbed(device="cpu")


@pytest.fixture(scope="module")
def plans(params, ref_params, clusters):
    return (RC.plan_for_params(ref_params, clusters[0], **PLAN_KW),
            PC.plan_for_params(params, clusters[1], **PLAN_KW))


@pytest.fixture(scope="module")
def plan(plans):
    return plans[1]


def _as_port_plan(ref_plan):
    """The reference's plan as the port's dataclasses (one layout for both
    stores, so their files can be compared byte for byte)."""
    groups = tuple(PC.GroupPlan(name=g.name, leaves=g.leaves, nbytes=g.nbytes, k=g.k, n=g.n,
                                placement=g.placement, pi=np.asarray(g.pi))
                   for g in ref_plan.groups)
    return PC.CheckpointPlan(groups=groups, cluster_size=ref_plan.cluster_size,
                             chunk_mb=ref_plan.chunk_mb, theta=ref_plan.theta,
                             latency_bound=ref_plan.latency_bound,
                             storage_cost=ref_plan.storage_cost)


def _ref_uniforms(seed, n_groups):
    """The reference's per-group Madow uniforms: ``fold_in(key(seed), i)``."""
    key = jax.random.key(seed)
    return [float(jax.random.uniform(jax.random.fold_in(key, i), (), jnp.float32))
            for i in range(n_groups)]


# ----------------------------------------------------------------- planner


def test_leaf_names_and_groups_match_reference(params, ref_params):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_params)
    assert [k for k, _ in flatten_with_keys(params)] == [
        jax.tree_util.keystr(p) for p, _ in flat]
    for group_mb in (0.005, 0.01, 64.0):
        assert PC.pack_groups(params, group_mb) == RC.pack_groups(ref_params, group_mb)
    # the port's Model holds the reference's tree: same names, same order
    smoke = get_smoke_config("smollm-135m")
    ours = Model(smoke, device="cpu").init(torch.Generator().manual_seed(0))
    from repro.models import Model as RefModel
    theirs = jax.eval_shape(RefModel(smoke).init, jax.random.key(0))
    assert [k for k, _ in flatten_with_keys(ours)] == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(theirs)[0]]


def test_pack_groups_covers_all_leaves(params):
    groups = PC.pack_groups(params, group_mb=0.01)
    assert {k for keys, _ in groups for k in keys} == {k for k, _ in flatten_with_keys(params)}


def _assert_plans_agree(got, want):
    """Every field; of the placement, the nodes pi uses and the count. The
    durability floor ranks spares by -pi, then cost, and the reference's pi
    keeps float32 residues (4.8e-7) below the placement threshold where the
    port's is exactly 0 (``ROADMAP.md`` §C), so the spares may differ."""
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        for field in ("name", "leaves", "nbytes", "k", "n"):
            assert getattr(g, field) == getattr(w, field), (g.name, field)
        used = int((np.asarray(w.pi) > 1e-3).sum())
        assert used == int((g.pi > 1e-3).sum()) and used >= g.k
        assert set(g.placement[:used]) == set(w.placement[:used]), g.name
        assert len(set(g.placement)) == g.n
        assert isinstance(g.pi, np.ndarray) and g.pi.shape == np.asarray(w.pi).shape
        np.testing.assert_allclose(g.pi, np.asarray(w.pi), atol=PI_ATOL)
    assert got.cluster_size == want.cluster_size and got.chunk_mb == want.chunk_mb
    np.testing.assert_allclose(got.latency_bound, want.latency_bound, rtol=1e-4)
    np.testing.assert_allclose(got.storage_cost, want.storage_cost, rtol=1e-5)


def test_plan_matches_reference(plans):
    _assert_plans_agree(plans[1], plans[0])


def test_plan_is_mds_feasible(plan, clusters):
    for g in plan.groups:
        assert g.n >= g.k, (g.name, g.n, g.k)
        assert g.n <= clusters[1].m
        assert len(set(g.placement)) == g.n
        assert abs(g.pi.sum() - g.k) < 1e-3
    assert any(g.n > g.k for g in plan.groups)  # small theta buys redundancy


def test_high_theta_cuts_cost(params, clusters):
    kw = dict(group_mb=0.01, chunk_mb=0.004)
    cheap = PC.plan_for_params(params, clusters[1], theta=50.0, **kw)
    rich = PC.plan_for_params(params, clusters[1], theta=0.001, **kw)
    assert cheap.storage_cost <= rich.storage_cost + 1e-6


def test_replan_after_failure(plan, plans, clusters):
    failed = {plan.groups[0].placement[0]}
    got = plan.replan_after_failure(clusters[1], failed, read_rate=1 / 600)
    for g in got.groups:
        assert not (set(g.placement) & failed)
        assert g.n >= g.k
    want = plans[0].replan_after_failure(clusters[0], failed, read_rate=1 / 600)
    _assert_plans_agree(got, want)


@pytest.mark.parametrize("seed", [0, 3, 42])
def test_read_sets_match_reference(plans, seed):
    ref_plan, plan = plans
    alive = set(range(12)) - {plan.groups[0].placement[-1]}
    key = jax.random.key(seed)
    us = _ref_uniforms(seed, len(plan.groups))
    for gi, (g, w) in enumerate(zip(plan.groups, ref_plan.groups)):
        want = RC.sample_read_set(jax.random.fold_in(key, gi), w, alive, 12)
        assert PC.sample_read_set(us[gi], _as_port_plan(ref_plan).groups[gi], alive, 12) == want
        got = PC.sample_read_set(torch.Generator().manual_seed(seed), g, alive, 12)
        assert len(got) == g.k and set(got) <= set(g.placement) & alive


def test_smollm_full_tree_plans_as_the_reference():
    """checkpoint_catalogs.py's rule on SmolLM-135M's float32 tree: group_mb
    = max(64, MB / 200), theta 0.5, at its chunk_mb = group_mb / 8 and at
    group_mb / 4. At /8 the four largest groups have k = 11 of the 12
    nodes, so n = 12 and they survive one failure, not two; at /4 every
    group keeps n - k = 2."""
    tree = Model(get_config("smollm-135m"), device="meta").init(torch.Generator())
    from repro.models import Model as RefModel
    from repro.storage import tahoe_testbed as ref_testbed
    abstract = jax.eval_shape(RefModel(get_config("smollm-135m")).init, jax.random.key(0))
    nbytes = sum(PC.planner.leaf_nbytes(v) for _, v in flatten_with_keys(tree))
    assert nbytes == 134_515_008 * 4
    group_mb = max(64.0, nbytes / 2**20 / 200)
    tolerance = {}
    for div in (8, 4):
        kw = dict(group_mb=group_mb, chunk_mb=group_mb / div, theta=0.5)
        got = PC.plan_for_params(tree, PS.tahoe_testbed(device="cpu"), **kw)
        want = RC.plan_for_params(abstract, ref_testbed(), **kw)
        _assert_plans_agree(got, want)
        tolerance[div] = sorted(g.n - g.k for g in got.groups)
    assert tolerance[8] == [1, 1, 1, 1, 2, 2] and min(tolerance[4]) == 2


# ------------------------------------------------------------------- store


def test_roundtrip_no_failures(params, plan, tmp_path):
    store = PC.ECCheckpointStore(tmp_path, plan)
    store.save(params, step=100)
    _leaves_equal(store.restore(100, params), params)


def test_restore_survives_max_failures(params, plan, tmp_path):
    store = PC.ECCheckpointStore(tmp_path / "f", plan)
    store.save(params, step=5)
    tolerance = min(g.n - g.k for g in plan.groups)
    victims = set()
    for g in plan.groups:
        for node in g.placement:
            if len(victims) < tolerance:
                victims.add(node)
    for v in victims:
        store.fail_node(v)
    assert not store.alive_nodes() & victims
    _leaves_equal(store.restore(5, params, seed=3), params)


def test_restore_fails_loudly_beyond_tolerance(params, plan, tmp_path):
    store = PC.ECCheckpointStore(tmp_path / "g", plan)
    store.save(params, step=6)
    g0 = plan.groups[0]
    for node in g0.placement[: g0.n - g0.k + 1]:
        store.fail_node(node)
    with pytest.raises(RuntimeError, match="data loss"):
        store.restore(6, params)


def test_restore_randomizes_read_set(params, plan, tmp_path):
    store = PC.ECCheckpointStore(tmp_path / "h", plan)
    store.save(params, step=9)
    _leaves_equal(store.restore(9, params, seed=0), store.restore(9, params, seed=42))


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_chunks_and_manifests_byte_identical_and_cross_restore(params, ref_params, plans,
                                                               tmp_path):
    ref_plan = plans[0]
    port_plan = _as_port_plan(ref_plan)
    ref_store = RC.ECCheckpointStore(tmp_path / "ref", ref_plan)
    port_store = PC.ECCheckpointStore(tmp_path / "port", port_plan)
    ref_manifest = ref_store.save(ref_params, step=3)
    port_manifest = port_store.save(params, step=3)
    assert port_manifest == ref_manifest
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert port_files.keys() == ref_files.keys() and len(port_files) > 1
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    assert json.loads(port_files["manifest_3.json"])["leaves"]["['stack']['w2']"][
        "dtype"] == "bfloat16"
    # a failure that forces parity reads, then each package restores the other's
    victim = ref_plan.groups[0].placement[0]
    for store in (ref_store, port_store):
        store.fail_node(victim)
    us = _ref_uniforms(11, len(ref_plan.groups))
    from_ref = PC.ECCheckpointStore(tmp_path / "ref", port_plan).restore(3, params, uniforms=us)
    _leaves_equal(from_ref, params)
    from_port = RC.ECCheckpointStore(tmp_path / "port", ref_plan).restore(3, ref_params, seed=11)
    _ref_leaves_equal(from_port, params)
    assert from_ref["stack"]["step"].shape == () and int(from_ref["stack"]["step"]) == 7


def test_full_train_state_roundtrip(clusters, tmp_path):
    """tests/test_checkpoint.py::TestTrainStateRoundtrip on the port: the
    reference's smoke SmolLM-135M state (params and a zero AdamW moment)
    carried across with params_from_numpy, planned, saved, a node failed,
    restored bitwise."""
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro.models import Model as RefModel
    from repro.optim import AdamW
    ref_params = RefModel(ref_smoke("smollm-135m")).init(jax.random.key(1))
    ref_state = {"params": ref_params, "opt_m": AdamW(lr=1e-3).init(ref_params).m}
    state = params_from_numpy(jax.tree.map(np.asarray, ref_state), device="cpu")
    kw = dict(group_mb=0.05, chunk_mb=0.01, theta=0.1)
    plan = PC.plan_for_params(state, clusters[1], **kw)
    _assert_plans_agree(plan, RC.plan_for_params(ref_state, clusters[0], **kw))
    store = PC.ECCheckpointStore(tmp_path / "ts", plan)
    store.save(state, step=0)
    store.fail_node(plan.groups[0].placement[-1])
    got = store.restore(0, state)
    _leaves_equal(got, state)
    assert isinstance(got["params"]["stack"]["period"], list)


def test_train_state_checkpoint_matches_reference_byte_for_byte(clusters, tmp_path):
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro.data.pipeline import SyntheticLM as RefSyntheticLM
    from repro.launch import steps as RS
    from repro.models import Model as RefModel
    from repro.optim import AdamW, AdamWState
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import AdamWState as PortAdamWState

    cfg = ref_smoke("smollm-135m")
    model, opt = RefModel(cfg), AdamW(lr=1e-3)
    ref_params = model.init(jax.random.key(2))
    ref_state = RS.TrainState(ref_params, opt.init(ref_params))
    ref_state, _ = jax.jit(RS.make_train_step(model, opt))(
        ref_state, RefSyntheticLM(cfg.vocab, 16, 2).batch_at(0))
    numpy_state = jax.tree.map(np.asarray, ref_state)
    opt_state = params_from_numpy(numpy_state.opt, device="cpu")
    assert isinstance(opt_state, AdamWState) and opt_state._fields == ("step", "m", "v")
    assert opt_state.step.dtype == torch.int32 and opt_state.step.shape == ()
    state = TrainState(params_from_numpy(numpy_state.params, device="cpu"),
                       PortAdamWState(*opt_state))

    names = [k for k, _ in flatten_with_keys(state)]
    assert names == [jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(ref_state)[0]]
    assert names[0] == ".params['embed']" and ".opt.step" in names
    assert ".opt.m['stack']['period'][0]['attn']['wq']" in names
    kw = dict(group_mb=0.05, chunk_mb=0.01, theta=0.1)
    assert PC.pack_groups(state, kw["group_mb"]) == RC.pack_groups(ref_state, kw["group_mb"])
    ref_plan = RC.plan_for_params(ref_state, clusters[0], **kw)
    _assert_plans_agree(PC.plan_for_params(state, clusters[1], **kw), ref_plan)
    assert len(ref_plan.groups) > 3

    port_plan = _as_port_plan(ref_plan)
    ref_store = RC.ECCheckpointStore(tmp_path / "ref", ref_plan)
    port_store = PC.ECCheckpointStore(tmp_path / "port", port_plan)
    assert port_store.save(state, step=1) == ref_store.save(ref_state, step=1)
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert port_files.keys() == ref_files.keys()
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    leaves = json.loads(port_files["manifest_1.json"])["leaves"]
    assert leaves[".opt.step"] == {"shape": [], "dtype": "int32"}

    victim = ref_plan.groups[0].placement[0]  # the first group's first node
    for store in (ref_store, port_store):
        store.fail_node(victim)
    us = _ref_uniforms(5, len(ref_plan.groups))
    from_ref = PC.ECCheckpointStore(tmp_path / "ref", port_plan).restore(1, state, uniforms=us)
    _leaves_equal(from_ref, state)
    assert isinstance(from_ref, TrainState) and isinstance(from_ref.opt, PortAdamWState)
    assert int(from_ref.opt.step) == 1
    from_port = RC.ECCheckpointStore(tmp_path / "port", ref_plan).restore(1, ref_state, seed=5)
    _ref_leaves_equal(from_port, state)
