"""The port's MoE expert-parallel island against the reference's, on a
(2, 2) ('data', 'model') mesh.

The port runs in a gloo world of four ranks (``test_torch_gloo.run_ranks``);
the reference runs in a subprocess on four fake CPU devices
(``--xla_force_host_platform_device_count=4``) on the same mesh, outside
``set_mesh`` (inside it the reference's ``ragged_dot_general`` has no
sharding rule). Both take the same inputs: the reference's ``moe_init``
weights, x and the output cotangent gy from numpy with a seed.

Cases: DeepSeek-V3's smoke config (a shared expert) and Qwen3-MoE's, with x
of shape (4, 1) (the tiny path: tokens gathered over 'data', weights
resident) and (4, 2100) (the ZeRO path: t_local * top_k = 8400 > 4096,
expert ff slices gathered), and of one sequence, narrower than the 'data'
axis, placed as the sharding rules place such a batch (replicated): (1, 2)
(the tiny path) and (1, 2100) (the ZeRO path; t_local = 2100 counts the
whole sequence a rank, as the reference's arithmetic does, though each
rank holds 1050 rows). Held: y at atol 1e-5, aux at atol 1e-5, and
the gradients of sum(y * gy) + 100 * aux for every parameter (router and
shared expert included) and for x, each within 2e-6 of its leaf's
largest entry.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_gloo import moe_ep_rank, run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
AUX_SCALE = 100.0
CASES = {
    f"{arch}-{t}" if b == 4 else f"{arch}-{b}x{t}": (arch, b, t)
    for arch in ("deepseek-v3-671b", "qwen3-moe-30b-a3b")
    for b, t in ((4, 1), (4, 2100), (1, 2), (1, 2100))
}

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_smoke_config
    from repro.models import EPSpec
    from repro.models.moe import moe_apply, moe_init

    inp, out, aux_scale = sys.argv[1], sys.argv[2], float(sys.argv[3])
    data = np.load(inp)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ep = EPSpec(mesh=mesh, ep_axis="model", fsdp_axes=("data",), dp_axes=("data",))
    res = {}
    for name in sorted({k.split("/")[0] for k in data.files}):
        arch = str(data[name + "/arch"])
        cfg = get_smoke_config(arch)
        p = moe_init(jax.random.key(int(data[name + "/seed"])), cfg, jnp.float32)
        x, gy = jnp.asarray(data[name + "/x"]), jnp.asarray(data[name + "/gy"])

        def loss(p, x):
            y, aux = moe_apply(p, x, cfg, ep)
            return jnp.sum(y * gy) + aux_scale * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                             has_aux=True))(p, x)
        res[name + "/y"], res[name + "/aux"], res[name + "/x_grad"] = y, aux, gx
        for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            res[name + "/param" + jax.tree_util.keystr(path)] = v
        for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            res[name + "/grad" + jax.tree_util.keystr(path)] = v
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both islands on every case: (reference's arrays, port's results)."""
    from repro_torch.configs.registry import get_smoke_config

    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = {}
    for i, (name, (arch, b, t)) in enumerate(CASES.items()):
        d = get_smoke_config(arch).d_model
        rng = np.random.default_rng(i)
        inputs[name + "/arch"] = np.array(arch)
        inputs[name + "/seed"] = np.array(i)
        inputs[name + "/x"] = (0.3 * rng.standard_normal((b, t, d))).astype(np.float32)
        inputs[name + "/gy"] = rng.standard_normal((b, t, d)).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
                           str(tmp / "ref.npz"), str(AUX_SCALE)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp / "ref.npz")

    cases = {}
    for name, (arch, _, _) in CASES.items():
        prefix = name + "/param"
        flat = {k[len(prefix):]: torch.from_numpy(ref[k].copy()) for k in ref.files
                if k.startswith(prefix)}
        params = _tree(flat)
        cases[name] = dict(arch=arch, params=params, aux_scale=AUX_SCALE,
                           x=torch.from_numpy(inputs[name + "/x"]),
                           gy=torch.from_numpy(inputs[name + "/gy"]))
    torch.save(cases, tmp / "port_in.pt")
    run_ranks(moe_ep_rank, 4, str(tmp / "port_in.pt"), str(tmp / "port.pt"))
    return ref, torch.load(tmp / "port.pt", weights_only=False), cases


def _tree(flat: dict) -> dict:
    """A nested dict from keystr names (``['shared']['w_up']``)."""
    out: dict = {}
    for key, v in flat.items():
        names = [part.strip("'") for part in key.strip("[]").split("][")]
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = v
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_island_output_and_aux_match_reference(runs, name):
    ref, port, _ = runs
    got = port[name]
    np.testing.assert_allclose(got["y"].numpy(), ref[name + "/y"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got["aux"]), float(ref[name + "/aux"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_island_gradients_match_reference(runs, name):
    ref, port, _ = runs
    got = port[name]
    want = {k[len(name + "/grad"):]: ref[k] for k in ref.files if k.startswith(name + "/grad")}
    assert set(got["grads"]) == set(want)
    if CASES[name][0] == "deepseek-v3-671b":
        assert any("shared" in k for k in want)
    for key, w in list(want.items()) + [("x", ref[name + "/x_grad"])]:
        g = (got["grads"][key] if key != "x" else got["x_grad"]).numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, key
        np.testing.assert_allclose(g, w, atol=2e-6 * scale, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_island_aux_is_the_mean_of_each_shards_term(runs, name):
    """(4, 1) and (1, 2): t_local * top_k <= 4096, the tiny path, whose
    shards route all gathered tokens, so aux is the local path's; (4, 2100)
    and (1, 2100): the ZeRO path, whose aux is the mean of the two data
    shards' own terms, each shard half of x's rows."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.moe import moe_apply

    _, port, cases = runs
    arch, b, t = CASES[name]
    cfg = get_smoke_config(arch)
    assert (max(b // 2, 1) * t * cfg.moe.top_k <= 4096) == (t < 2100)
    case = cases[name]
    if t < 2100:
        want = moe_apply(case["params"], case["x"], cfg)[1]
    else:
        rows = case["x"].reshape(1, b * t, -1)
        want = sum(moe_apply(case["params"], half, cfg)[1] for half in rows.chunk(2, dim=1)) / 2
        assert abs(float(want) - float(moe_apply(case["params"], case["x"], cfg)[1])) > 1e-8
    np.testing.assert_allclose(float(port[name]["aux"]), float(want), atol=1e-8, rtol=0)
