"""The port's training path against the reference, on the CPU at smoke size.

* ``chunked_softmax_xent`` at ``tests/test_perf_opts.py``'s (vocab, chunk)
  cases against the reference's and the dense CE, rtol / atol 2e-5.
* ``Model.loss`` at O0 (naive attention, dense CE) and on the chunked path
  (q / k blocks of 8, ``vocab_chunk=64``; kernel B4's plain twin and its
  backward on the CPU) against ``repro``'s loss at rtol 2e-4 (the
  tolerance of ``test_optimized_model_matches_baseline``), and its
  gradients against ``jax.grad(model.loss)`` at atol 1e-4, on the smoke
  SmolLM and on a windowed, untied stack with a prefix and a suffix.
* ``remat`` "full" and "dots" bitwise to "none" (the CPU recomputes the
  same ops in the same order); "dots" keeps the plain matrix products and
  "full" recomputes them.
* Three ``make_train_step`` steps from the reference's weights on the
  reference's own batches: loss and grad norm at rtol 2e-4, parameters and
  both moments at atol 1e-5.
* ``build_model`` and ``abstract_train_state`` against the reference's.
* A short ``train()`` with checkpoints of the whole ``TrainState``, a
  storage-node failure and a resume that restores bitwise what was saved.

Inputs come from numpy with a seed or from the reference's
``SyntheticLM``; weights are carried across with ``params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
import repro.optim as RO
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.attention_opt import chunked_softmax_xent as ref_xent
import repro_torch.launch.steps as PS
import repro_torch.optim as PO
from repro_torch.checkpoint import ECCheckpointStore
from repro_torch.launch import train as train_mod
from repro_torch.models import params_from_numpy
from repro_torch.models.attention_opt import chunked_softmax_xent
from repro_torch.tree import flatten_with_keys, tree_leaves, tree_unflatten
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMOKE = ref_smoke_config("smollm-135m")
CONFIGS = {
    "smollm": SMOKE,
    "local": dataclasses.replace(SMOKE, n_layers=6, prefix=("attn",), suffix=("dense",),
                                 period=("local", "attn"), window=8, rotary_pct=0.75,
                                 tie_embeddings=False),
}
CHUNKED = dict(attn_impl="chunked", attn_q_blk=8, attn_k_blk=8, vocab_chunk=64)


def _ref_keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port, ref, **tol):
    ref = _ref_keyed(ref)
    port = dict(flatten_with_keys(port))
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        np.testing.assert_allclose(port[key].detach().numpy(), want, err_msg=key, **tol)


def _models(cfg, **kw):
    ref = dataclasses.replace(RS.build_model(cfg, None, dtype=jnp.float32, remat="none"), **kw)
    port = dataclasses.replace(
        PS.build_model(cfg, dtype=torch.float32, remat="none", device="cpu"), **kw)
    ref_params = ref.init(jax.random.key(0))
    return ref, port, ref_params, params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                                    device="cpu")


def _tokens(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ------------------------------------------------------------- chunked CE


@pytest.mark.parametrize("vocab,chunk", [(50, 16), (64, 64), (100, 33)])
def test_chunked_xent_matches_reference_and_dense(vocab, chunk):
    rng = np.random.default_rng(vocab)
    h = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = rng.standard_normal((16, vocab)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 6)).astype(np.int32)
    got = chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(labels), chunk=chunk)
    want = ref_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    logits = torch.from_numpy(h) @ torch.from_numpy(w)
    dense = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- loss and gradients


@pytest.mark.parametrize("path", ["O0", "chunked"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_reference(name, path):
    cfg = CONFIGS[name]
    ref, port, ref_params, params = _models(cfg, **(CHUNKED if path == "chunked" else {}))
    toks = _tokens(cfg)
    want, ref_grads = jax.value_and_grad(ref.loss)(ref_params, {"tokens": jnp.asarray(toks)})
    loss, grads = PS.loss_and_grads(port, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    _close_trees(grads, ref_grads, atol=1e-4, rtol=0)
    # explicit labels, as the reference reads them
    labels = _tokens(cfg, seed=1)
    want = ref.loss(ref_params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got = port.loss(params, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    assert got.grad_fn is None  # no parameter asked for a gradient


def test_forward_logits_keeps_the_graph():
    _, port, _, params = _models(SMOKE)
    leaf = params["ln_f"]["scale"].requires_grad_()
    logits = port.forward_logits(params, {"tokens": torch.from_numpy(_tokens(SMOKE))})
    assert logits.grad_fn is not None and leaf.requires_grad


def _mm_calls_in_backward(model, params, batch) -> int:
    """aten.mm calls the backward makes (recomputed forward products
    included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    leaves = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves), batch)
    with Count():
        torch.autograd.grad(loss, leaves)
    return Count.n


@pytest.mark.parametrize("path", ["O0", "chunked"])
def test_remat_is_bitwise_and_recomputes_what_it_should(path):
    cfg = CONFIGS["local"]
    _, port, _, params = _models(cfg, **(CHUNKED if path == "chunked" else {}))
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    loss, grads = PS.loss_and_grads(port, params, batch)
    for remat in ("full", "dots"):
        got, got_grads = PS.loss_and_grads(dataclasses.replace(port, remat=remat), params, batch)
        assert torch.equal(got, loss), remat
        for (key, g), (_, want) in zip(flatten_with_keys(got_grads), flatten_with_keys(grads)):
            assert torch.equal(g, want), (remat, key)
    counts = {remat: _mm_calls_in_backward(dataclasses.replace(port, remat=remat), params,
                                           batch) for remat in ("none", "dots", "full")}
    # "dots" recomputes no product; "full" recomputes at least the six of a
    # block's seven (q, k, v, o, gate, up, down) its backward reads (a
    # region stops recomputing once the backward has what it needs)
    assert counts["dots"] == counts["none"]
    assert counts["full"] >= counts["none"] + 6 * cfg.n_periods * len(cfg.period)
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(port, remat="names")


# ------------------------------------------------------------- train steps


@pytest.mark.parametrize("path", ["O0", "chunked"])
def test_three_train_steps_on_reference_batches(path):
    cfg = SMOKE
    ref, port, ref_params, params = _models(cfg, **(CHUNKED if path == "chunked" else {}))
    ref_opt = RO.AdamW(lr=RO.cosine_schedule(3e-3, warmup=20, total=200), weight_decay=0.01)
    port_opt = PO.AdamW(lr=PO.cosine_schedule(3e-3, warmup=20, total=200), weight_decay=0.01)
    ref_state = RS.TrainState(ref_params, ref_opt.init(ref_params))
    state = PS.TrainState(params, port_opt.init(params))
    ref_step = jax.jit(RS.make_train_step(ref, ref_opt))
    step = PS.make_train_step(port, port_opt)
    data = RefSyntheticLM(cfg.vocab, 32, 4)
    for i in range(3):
        batch = data.batch_at(i)
        ref_state, ref_metrics = ref_step(ref_state, batch)
        state, metrics = step(state, {"tokens": torch.from_numpy(np.array(batch["tokens"]))})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), rtol=2e-4)
        _close_trees(state, ref_state, atol=1e-5, rtol=0)
    assert isinstance(state, PS.TrainState) and isinstance(state.opt, PO.AdamWState)
    assert int(state.opt.step) == 3


def test_build_model_and_abstract_state_match_reference():
    for level in PS.OPT_LEVELS:
        ref = RS.build_model(SMOKE, None, dtype=jnp.float32, opt=level)
        port = PS.build_model(SMOKE, dtype=torch.float32, opt=level, device="cpu")
        for field in ("remat", "attn_impl", "attn_q_blk", "attn_k_blk", "cache_update",
                      "vocab_chunk"):
            assert getattr(port, field) == getattr(ref, field), (level, field)
    ref = RS.build_model(SMOKE, None, dtype=jnp.float32)
    port = PS.build_model(SMOKE, dtype=torch.float32, device="cpu")
    want = RS.abstract_train_state(ref, RO.AdamW())
    got = PS.abstract_train_state(port, PO.AdamW())
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flatten_with_keys(got)} == want
    assert all(v.device.type == "meta" for v in tree_leaves(got))


# ------------------------------------------------------------------ train()


def test_train_checkpoints_fails_a_node_and_resumes_bitwise(tmp_path, monkeypatch):
    """15 steps saving at step 10 (``step and step % ckpt_every == 0``), a
    storage node failing at 12, then a resume that restores step 10 from
    the degraded store and replays from step 10, saving it again."""
    saved = {}
    save = ECCheckpointStore.save

    def snapshot(self, state, step):
        saved[step] = [leaf.clone() for leaf in tree_leaves(state)]
        return save(self, state, step)

    monkeypatch.setattr(ECCheckpointStore, "save", snapshot)
    root = str(tmp_path / "ckpt")
    kw = dict(steps=15, batch=4, seq=32, ckpt_dir=root, ckpt_every=10, log_every=5,
              device="cpu")
    state, losses, store = train_mod.train(fail_node_at=12, **kw)
    assert list(saved) == [10] and len(losses) == 15 and np.isfinite(losses).all()
    victim = store.plan.groups[0].placement[0]
    assert victim not in store.alive_nodes()
    assert isinstance(state, PS.TrainState) and int(state.opt.step) == 15
    held = saved.pop(10)

    restored = {}
    restore = ECCheckpointStore.restore

    def record(self, step, template, **kwargs):
        restored[step] = restore(self, step, template, **kwargs)
        return restored[step]

    monkeypatch.setattr(ECCheckpointStore, "restore", record)
    state2, losses2, _ = train_mod.train(resume=True, **kw)
    assert list(restored) == [10] and list(saved) == [10] and len(losses2) == 5
    for got, want in zip(tree_leaves(restored[10]), held):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert isinstance(restored[10], PS.TrainState)
    assert int(restored[10].opt.step) == 11  # the state after step 10's update
    assert int(state2.opt.step) == 16  # steps 10..14 again: batch 10 applied twice
    np.testing.assert_allclose(losses2[-1], losses[-1], rtol=0.05)


def test_train_with_grad_compression_and_the_cli(monkeypatch, capsys):
    _, losses, store = train_mod.train(steps=60, batch=4, seq=32, grad_compress=True,
                                       log_every=20, device="cpu")
    assert store is None and losses[-1] < losses[0] - 0.3
    monkeypatch.setattr("sys.argv", ["train", "--steps", "2", "--batch", "2", "--seq", "8",
                                     "--device", "cpu"])
    train_mod.main()
    assert "[train] done: 2 steps" in capsys.readouterr().out
