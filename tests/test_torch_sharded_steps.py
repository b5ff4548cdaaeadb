"""The port's sharded train, prefill and decode steps on a (2, 2)
('data', 'model') gloo mesh, against its unsharded steps and the reference.

Two worlds of four ranks (``test_torch_gloo.sharded_steps_rank``), spawned
once for the module and run at once, each taking half the cases, run:

* ``jit_train_step`` for two steps from one state for each of the ten
  archs' smoke configs at O0 (naive attention, dense CE; the MoE archs
  through the expert-parallel island), and SmolLM's at O2 (batch pins,
  kernel B4's plain twin on local blocks, chunked CE), with
  ``remat="none"`` as ``train()`` builds; a third world runs SmolLM's O0
  steps on a (2, 1, 2) ('pod', 'data', 'model') mesh, the batch over two
  DP axes as on the multi-pod mesh;
* ``jit_prefill_step`` at O3 and three ``jit_decode_step`` steps for SmolLM
  and for Qwen3-MoE.

Each is held to the port's unsharded step on the same inputs: loss and
grad norm of both steps at rtol 1e-5; both AdamW moments after each step
(after the first, m is the clipped gradient) within 1e-5 of each leaf's
largest entry. AdamW's update m / (sqrt(v) + eps) is ill-conditioned where
a gradient entry is near eps (a 1e-7 change of the gradient, a different
order of the same sums, moves it by a whole step there), so the
parameters are held as AdamW moves the start's with the sharded step's
own moments (within 1e-6 of the leaf's largest entry and 1e-5 lr), and
within 2 lr of the unsharded step's. Logits and caches at atol 1e-5. For
an MoE arch the loss's tolerance is widened by |aux_ep - aux_local| (the
island's aux is the mean of each shard's term; this batch takes its tiny
path, where the two agree). Where the unsharded step itself moves by more
when the embedding moves one float32 ulp (RWKV6, RecurrentGemma), a
tolerance widens to twice that movement, never past 1e-3 of its quantity
(ROADMAP §C lists the leaves); a 1 % fault planted in the loss, the grad
norm and the most widened moment leaf must fail. The unsharded step's
loss and gradients are held to the reference by
``test_torch_archs_loss.py``, ``test_torch_train.py``,
``test_torch_encdec.py`` and ``test_torch_rwkv6.py``; SmolLM's and
Qwen3-MoE's sharded steps are also held here to the reference's
``make_train_step`` under ``jax.jit``, at ``test_torch_train.py``'s
tolerances (loss and grad norm rtol 2e-4, parameters atol 1e-5).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
import repro.optim as RO
from repro.configs.registry import get_smoke_config as ref_smoke_config
import repro_torch.launch.steps as PS
from repro_torch.configs.registry import ARCHS, get_smoke_config
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.tree import flatten_with_keys, unflatten_like
from test_torch_gloo import run_worlds, sharded_steps_rank
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

B, S = 4, 16
SCHEDULE = dict(base_lr=3e-3, warmup=20, total=200)  # train()'s: lr 1.5e-4, 3e-4
TRAIN = {arch: (arch, "O0") for arch in ARCHS} | {"smollm-135m-O2": ("smollm-135m", "O2"),
                                                   "smollm-135m-2x1x2": ("smollm-135m", "O0")}
MESHES = {"smollm-135m-2x1x2": (2, 1, 2)}  # cases off the (2, 2) mesh, a world each
SERVE = ("smollm-135m", "qwen3-moe-30b-a3b")
JAX_HELD = ("smollm-135m", "qwen3-moe-30b-a3b")


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.from_numpy(
            (0.1 * rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))).astype(np.float32))
    if cfg.mrope_sections is not None:
        batch["patch_embeds"] = torch.from_numpy(
            (0.1 * rng.standard_normal((B, 4, cfg.d_model))).astype(np.float32))
        batch["positions"] = torch.arange(S).expand(3, B, S).contiguous()
    return batch


def _params(arch: str):
    model = PS.build_model(get_smoke_config(arch), dtype=torch.float32, device="cpu")
    return model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def cases():
    train = {name: dict(arch=arch, opt=opt, lr=SCHEDULE, params=_params(arch),
                        batches=[_batch(get_smoke_config(arch), i) for i in range(2)])
             for name, (arch, opt) in TRAIN.items()}
    serve = {}
    for arch in SERVE:
        rng = np.random.default_rng(7)
        vocab = get_smoke_config(arch).vocab
        serve[arch] = dict(arch=arch, params=_params(arch), cache_len=S, steps=3,
                           tokens=torch.from_numpy(rng.integers(0, vocab, (B, S - 4))),
                           feed=torch.from_numpy(rng.integers(0, vocab, (B, 3))))
    return {"train": train, "serve": serve}


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    """The ranks' results. DTensor's host cost on a new op and shape (its
    sharding propagation) dominates, about 3-30 s an arch, so the cases go
    to two worlds that run at once."""
    tmp = tmp_path_factory.mktemp("sharded_steps")
    names = [n for n in cases["train"] if n not in MESHES]
    worlds = [{"train": {n: cases["train"][n] for n in names[i::2]},
               "serve": cases["serve"] if i == 0 else {}} for i in (0, 1)]
    worlds += [{"train": {n: cases["train"][n]}, "serve": {}, "mesh": shape}
               for n, shape in MESHES.items()]
    jobs = []
    for i, world in enumerate(worlds):
        torch.save(world, tmp / f"in{i}.pt")
        jobs.append((sharded_steps_rank, 4, (str(tmp / f"in{i}.pt"), str(tmp / f"out{i}.pt"))))
    run_worlds(jobs)
    out = [torch.load(tmp / f"out{i}.pt", weights_only=False) for i in range(len(worlds))]
    return {kind: {k: v for o in out for k, v in o[kind].items()} for kind in ("train", "serve")}


def _unsharded_steps(case, starts, nudge: float = 0.0):
    """The port's unsharded step from each state of ``starts`` on the
    matching batch, with the embedding moved one float32 ulp towards
    ``nudge`` (+inf or -inf) if given: (metrics, states as {key: array},
    the model's aux at the first state)."""
    cfg = get_smoke_config(case["arch"])
    model = PS.build_model(cfg, dtype=torch.float32, remat="none", opt=case["opt"],
                           device="cpu")
    step = PS.make_train_step(model, _opt(case))
    aux = model._hidden(case["params"], case["batches"][0])[1].detach()
    metrics, states = [], []
    for start, batch in zip(starts, case["batches"]):
        if nudge:
            moved = torch.nextafter(start.params["embed"], torch.tensor(nudge))
            start = start._replace(params=dict(start.params, embed=moved))
        state, m = step(start, batch)
        metrics.append(m)
        states.append(_leaves(state))
    return metrics, states, aux


def _opt(case) -> AdamW:
    return AdamW(lr=cosine_schedule(**case["lr"]))


def _leaves(tree) -> dict:
    return {k: v.detach().numpy() for k, v in flatten_with_keys(tree)}


def _hold_state(got, want: dict, start, opt: AdamW, tol):
    """One sharded step's state against ``want`` ({key: array}), a step from
    the same ``start``: both moments (m carries the step's clipped
    gradient, v its square) within ``tol(key, want)`` (v at twice it: a
    square doubles a relative error); the parameters as AdamW moves
    ``start``'s with the sharded step's own moments, within 1e-6 of the
    leaf's largest entry and 1e-5 lr (float32 rounding of the update), and
    within 2 lr of ``want``'s.
    The parameters are not held to ``want``'s closer: the update
    m / (sqrt(v) + eps) is ill-conditioned where a gradient entry is near
    eps, so a 1e-7 change of the gradient (another order of the same sums)
    moves it by up to a whole step there. The step count exactly."""
    got, start = _leaves(got), _leaves(start)
    assert got.keys() == want.keys()
    step = int(want[".opt.step"])
    lr = float(opt.lr(torch.tensor(step)))
    bc1, bc2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    for key, w in want.items():
        g = got[key]
        if key == ".opt.step":
            assert int(g) == step
        elif key.startswith(".params"):
            name = key[len(".params"):]
            p0 = start[key].astype(np.float64)
            m, v = got[".opt.m" + name], got[".opt.v" + name]
            u = (m / bc1) / (np.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p0
            np.testing.assert_allclose(g, p0 - lr * u, rtol=0,
                                       atol=1e-6 * float(np.abs(p0).max()) + 1e-5 * lr,
                                       err_msg=key)
            assert np.abs(g - w).max() <= 2 * lr, key
        else:
            scale = 2.0 if key.startswith(".opt.v") else 1.0
            np.testing.assert_allclose(g, w, atol=scale * tol(key, w), rtol=0, err_msg=key)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_steps_match_the_unsharded(cases, sharded, name):
    """Each sharded step against the unsharded step from the same state
    (the first from the case's, the second from the sharded first's): loss
    and grad norm at rtol 1e-5, widened by the island's aux difference, and
    the state by ``_hold_state`` at 1e-5 of each leaf's largest entry. Each
    is widened to twice the unsharded step's own movement when the
    embedding moves one float32 ulp up or down: RWKV6's gradients are
    ill-conditioned at random weights (ROADMAP §C), and the sharded step
    reorders sums all through the model, not at the embedding alone;
    elsewhere the movement is below the tolerance. No widened tolerance
    may pass 1e-3 of its quantity (the leaf's largest entry), and a 1 %
    fault planted in the loss, the grad norm and the most widened moment
    leaf must fail."""
    case, got = cases["train"][name], sharded["train"][name]
    opt = _opt(case)
    starts = [PS.TrainState(case["params"], opt.init(case["params"]))] + got["states"][:-1]
    metrics, states, aux = _unsharded_steps(case, starts)
    nudged = [_unsharded_steps(case, starts, nudge)[:2] for nudge in (np.inf, -np.inf)]
    slack = abs(float(got["aux"]) - float(aux))
    for i, (m_got, m_want) in enumerate(zip(got["metrics"], metrics)):
        for key in ("loss", "grad_norm"):
            move = 2 * max(abs(float(m[i][key]) - float(m_want[key])) for m, _ in nudged)
            atol = move + (slack if key == "loss" else 0.0)
            want = float(m_want[key])
            assert atol <= 1e-3 * abs(want), f"step {i + 1} {key}: widened to {atol:.3g}"
            np.testing.assert_allclose(float(m_got[key]), want, rtol=1e-5, atol=atol,
                                       err_msg=f"step {i + 1} {key}")
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(1.01 * float(m_got[key]), want, rtol=1e-5, atol=atol)

        def tol(key, w, i=i):
            # _hold_state doubles v's tolerance; its movement is v's own
            half = 0.5 if key.startswith(".opt.v") else 1.0
            return max([1e-5 * float(np.abs(w).max())] + [
                2 * half * float(np.abs(s[i][key] - w).max()) for _, s in nudged])

        widened = {key: (2 if key.startswith(".opt.v") else 1) * tol(key, w)
                   / (float(np.abs(w).max()) or 1.0)
                   for key, w in states[i].items() if key.startswith(".opt.")
                   and key != ".opt.step"}
        assert max(widened.values()) <= 1e-3, (i + 1, max(widened.items(), key=lambda kv: kv[1]))
        _hold_state(got["states"][i], states[i], starts[i], opt, tol)
        worst = max(widened, key=widened.get)
        leaves = _leaves(got["states"][i])
        leaves[worst] = 1.01 * leaves[worst]
        faulty = unflatten_like(got["states"][i], {k: torch.from_numpy(v)
                                                   for k, v in leaves.items()})
        with pytest.raises(AssertionError):
            _hold_state(faulty, states[i], starts[i], opt, tol)


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_prefill_and_decode_match_the_unsharded(cases, sharded, arch):
    case, got = cases["serve"][arch], sharded["serve"][arch]
    model = PS.build_model(get_smoke_config(arch), dtype=torch.float32, opt="O3", device="cpu")
    toks = case["tokens"]
    logits, caches = model.prefill(case["params"], {"tokens": toks}, cache_len=case["cache_len"])
    want = [logits]
    for t in range(case["steps"]):
        batch = {"token": case["feed"][:, t], "pos": torch.full((B,), toks.shape[1] + t)}
        logits, caches = model.decode_step(case["params"], caches, batch)
        want.append(logits)
    assert len(got["logits"]) == len(want)
    for g, w in zip(got["logits"], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
    g_caches, w_caches = dict(flatten_with_keys(got["caches"])), dict(flatten_with_keys(caches))
    assert g_caches.keys() == w_caches.keys()
    for key, w in w_caches.items():
        np.testing.assert_allclose(g_caches[key].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("arch", JAX_HELD)
def test_sharded_train_steps_match_the_reference(cases, sharded, arch):
    """Each sharded step against the reference's jitted step from the same
    state: loss and grad norm at rtol 2e-4, the state by ``_hold_state`` at
    atol 1e-5 (``test_torch_train.py``'s tolerances)."""
    case, got = cases["train"][arch], sharded["train"][arch]
    ref = RS.build_model(ref_smoke_config(arch), None, dtype=jnp.float32, remat="none")
    opt = RO.AdamW(lr=RO.cosine_schedule(**case["lr"]))
    step = jax.jit(RS.make_train_step(ref, opt))
    abstract = jax.eval_shape(ref.init, jax.random.key(0))
    first = RS.TrainState(abstract, opt.init(abstract))

    def as_ref(state) -> RS.TrainState:
        leaves = _leaves(state)
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(leaves[jax.tree_util.keystr(path)]), first)

    port_opt = _opt(case)
    starts = [PS.TrainState(case["params"], port_opt.init(case["params"]))] + got["states"][:-1]
    for i, (start, batch) in enumerate(zip(starts, case["batches"])):
        state, m = step(as_ref(start), {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got["metrics"][i][key]), float(m[key]), rtol=2e-4)
        want = {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(state)[0]}
        _hold_state(got["states"][i], want, start, port_opt, lambda k, w: 1e-5)


def test_build_model_wires_the_mesh_as_the_reference_does():
    """EP for an MoE arch on a mesh with 'model'; pins from O2 up; neither
    without a mesh."""
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh("cpu")
    moe = PS.build_model(get_smoke_config("qwen3-moe-30b-a3b"), mesh, opt="O2", device="cpu")
    assert moe.ep is not None and moe.ep.mesh is mesh and moe.ep.ep_axis == "model"
    assert moe.ep.fsdp_axes == moe.ep.dp_axes == ("data",)
    assert moe.pin_mesh is mesh and moe.pin_axes == ("data",)
    dense = PS.build_model(get_smoke_config("smollm-135m"), mesh, opt="O1", device="cpu")
    assert dense.ep is None and dense.pin_mesh is None
    plain = PS.build_model(get_smoke_config("qwen3-moe-30b-a3b"), None, opt="O3", device="cpu")
    assert plain.ep is None and plain.pin_mesh is None
    ref = RS.build_model(ref_smoke_config("qwen3-moe-30b-a3b"), None, opt="O3")
    assert dataclasses.replace(plain, device=None).remat == ref.remat
