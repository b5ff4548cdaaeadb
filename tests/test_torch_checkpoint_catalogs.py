"""The checkpoint planner over all ten registered architectures, as
``benchmarks/checkpoint_catalogs.py`` runs the reference's, on the CPU.

For each arch the port's parameter tree is built on the ``meta`` device in
bfloat16 (no allocation: DeepSeek-V3's is 1.34 TB), against the
reference's ``jax.eval_shape`` of its init: leaf names, shapes, dtypes,
byte count and the shard groups ``pack_groups`` makes equal. Then the port
plans it at the benchmark's sizes (``group_mb = max(64, MB / 200)``,
``chunk_mb = group_mb / 8``, theta 0.5) on the port's 12-node testbed, and
every group keeps the benchmark's durability rule (``:51``): n - k >= 2,
or n = m. The plans are the port's alone: at these catalogs both solvers
stop in flat valleys (pi apart by up to 4.1e-3, one node of DeepSeek-V3's
support, the bounds within 1e-5; ``ROADMAP.md`` §C), which
``test_torch_checkpoint.py`` holds at its own sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
import repro_torch.checkpoint as PC
import repro_torch.storage as PS
from repro.configs.registry import get_config as ref_get_config
from repro.launch.steps import build_model as ref_build_model
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.lm import Model
from repro_torch.tree import flatten_with_keys
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def cluster():
    return PS.tahoe_testbed(device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_packs_as_the_reference_and_keeps_the_durability_rule(arch, cluster):
    tree = Model(get_config(arch), dtype=torch.bfloat16, device="meta").init(torch.Generator())
    abstract = jax.eval_shape(
        ref_build_model(ref_get_config(arch), None, dtype=jnp.bfloat16, remat="none").init,
        jax.random.key(0))
    leaves = dict(flatten_with_keys(tree))
    ref_leaves = {jax.tree_util.keystr(k): v
                  for k, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert list(leaves) == list(ref_leaves)
    for key, leaf in leaves.items():
        assert leaf.device.type == "meta", key
        assert (tuple(leaf.shape), str(leaf.dtype)[6:]) == (
            ref_leaves[key].shape, ref_leaves[key].dtype.name), key
    nbytes = sum(PC.planner.leaf_nbytes(leaf) for leaf in leaves.values())
    assert nbytes == sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
                         for x in jax.tree.leaves(abstract))
    group_mb = max(64.0, nbytes / 2**20 / 200)  # checkpoint_catalogs.py: <= ~200 groups
    groups = PC.planner.pack_groups(tree, group_mb)
    assert [(keys, b) for keys, b in groups] == [
        (list(keys), b) for keys, b in RC.planner.pack_groups(abstract, group_mb)]

    chunk_mb = group_mb / 8
    plan = PC.plan_for_params(tree, cluster, group_mb=group_mb, chunk_mb=chunk_mb, theta=0.5)
    m = cluster.m
    assert [(g.leaves, g.nbytes) for g in plan.groups] == [(tuple(keys), b) for keys, b in groups]
    assert np.isfinite(plan.latency_bound) and plan.storage_cost > 0
    for g in plan.groups:
        assert g.k == max(1, min(int(np.ceil(g.nbytes / (chunk_mb * 2**20))), m - 1)), g.name
        assert len(set(g.placement)) == g.n <= m and g.n >= g.k, g.name
        assert set(np.flatnonzero(g.pi > 1e-3)) <= set(g.placement), g.name
        assert g.n - g.k >= 2 or g.n == m, (arch, g.name, g.n, g.k)
