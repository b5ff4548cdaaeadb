"""Fault-tolerant training loop.

The port of ``repro/launch/train.py``. It wires together the model plane,
the synthetic data pipeline, AdamW and the paper's plane: erasure-coded
checkpoints with a JLCM-planned placement. It demonstrates

  * periodic EC checkpointing of the whole ``TrainState`` (parameters and
    both AdamW moments), encoded on kernel B2 on the card (any n - k node
    losses survivable),
  * crash / restart recovery from the newest manifest (the seekable data
    pipeline resumes exactly),
  * storage-node failure injection mid-run (the first group's first node),
  * optional int8 gradient compression with error feedback.

Resume keeps the reference's semantics: the state saved at step ``s`` is
the state after step ``s``'s update, and a resume runs ``range(s, steps)``,
so batch ``s`` is applied twice. As in the reference, training runs on a
mesh: ``make_local_mesh`` (a world of one unless a launcher started more),
the model built for it, the state placed by the sharding rules and each
step through ``jit_train_step``, an eager step over DTensors. A checkpoint
save gathers each leaf (``full_tensor``) before the EC store packs the
state, and a restore places the leaves again.

    PYTHONPATH=src python -m repro_torch.launch.train --full --ckpt-dir build/ckpt

trains SmolLM-135M at full width and depth on the card (``--device cpu``
and no ``--full`` train the smoke config on the host). On the card TF32 is
switched off, as in ``serve``.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import ECCheckpointStore, plan_for_params
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (
    TrainState,
    build_model,
    gather,
    jit_train_step,
    loss_and_grads,
    place,
)
from repro_torch.optim import AdamW, compress_decompress, compress_init, cosine_schedule
from repro_torch.storage import tahoe_testbed
from repro_torch.storage.cluster import _device


def train(
    arch: str = "smollm-135m",
    *,
    smoke: bool = True,
    steps: int = 200,
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-3,
    ckpt_every: int = 50,
    ckpt_dir: str | None = None,
    fail_node_at: int | None = None,
    grad_compress: bool = False,
    resume: bool = False,
    log_every: int = 10,
    dtype=torch.float32,
    device="cuda",
):
    dev = _device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    mesh = make_local_mesh(dev)
    model = build_model(cfg, mesh, dtype=dtype, remat="none", device=dev)
    opt = AdamW(lr=cosine_schedule(lr, warmup=20, total=steps), weight_decay=0.01)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch, device=dev)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(params=params, opt=opt.init(params))
    batch_sds = {"tokens": torch.empty((batch, seq), dtype=torch.int64, device="meta")}
    step_fn, _, state_sh, batch_sh = jit_train_step(model, opt, mesh, batch_sds)
    state = place(state, state_sh)
    cstate = compress_init(params) if grad_compress else None

    # --- paper plane: EC checkpoint store on the 3-site testbed model
    store = None
    start_step = 0
    if ckpt_dir:
        cluster = tahoe_testbed(device=dev)
        # plan over the FULL train state (params + optimizer moments)
        plan = plan_for_params(gather(state), cluster, group_mb=4.0, chunk_mb=1.0, theta=0.5)
        store = ECCheckpointStore(ckpt_dir, plan)
        print(
            f"[train] EC checkpoint plan: {len(plan.groups)} groups, "
            f"restore-latency bound {plan.latency_bound:.1f}s, "
            f"storage cost ${plan.storage_cost:.0f}"
        )
        latest = sorted(
            int(p.stem.split("_")[1]) for p in Path(ckpt_dir).glob("manifest_*.json")
        )
        if resume and latest:
            start_step = latest[-1]
            print(f"[train] restoring step {start_step} from EC store")
            state = place(store.restore(start_step, gather(state)), state_sh)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        b = data.batch_at(step)
        if grad_compress:
            # EF-compressed gradient path (wire-format modelled)
            with implicit_replication():
                loss, grads = loss_and_grads(model, state.params, place(b, batch_sh))
                grads, cstate = compress_decompress(grads, cstate)
                new_params, new_opt = opt.update(grads, state.opt, state.params)
            state = place(TrainState(new_params, new_opt), state_sh)
            metrics = gather({"loss": loss})
        else:
            state, metrics = step_fn(state, b)
        losses.append(float(gather(metrics["loss"])))
        if step % log_every == 0:
            print(f"[train] step {step:4d} loss {losses[-1]:.4f}")
        if store and step and step % ckpt_every == 0:
            store.save(gather(state), step)
            print(f"[train] EC checkpoint @ step {step}")
        if store and fail_node_at is not None and step == fail_node_at:
            victim = store.plan.groups[0].placement[0]
            store.fail_node(victim)
            print(f"[train] !! injected failure of storage node {victim}")
    wall = time.time() - t0
    print(
        f"[train] done: {steps - start_step} steps in {wall:.1f}s; "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
    )
    return state, losses, store


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-node-at", type=int, default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train(
        args.arch,
        smoke=not args.full,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        fail_node_at=args.fail_node_at,
        grad_compress=args.grad_compress,
        resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    main()
