"""AdamW in PyTorch ops (no ``torch.optim``), its schedule and grad utilities.

The port of ``repro/optim/adamw.py``, in the reference's functional form:
``AdamW.update(grads, state, params) -> (params, state)`` maps over
parameter trees (``repro_torch.tree``) and returns new tensors, so a train
step is a pure function of its ``TrainState``. State per parameter: m and
v in float32 (``state_dtype``); ``step`` is a 0-d int32 tensor, so a
checkpoint names and stores the leaves as the reference's does. Global-norm
clipping, decoupled weight decay, bias correction, and an int8 gradient
compression with error feedback. Arithmetic follows the reference's dtypes:
a clipped gradient is promoted as JAX promotes ``g * scale``, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch import Tensor

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 3e-4  # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params) -> AdamWState:
        """Zero moments beside each leaf (on its device, ``meta`` too)."""
        zeros = lambda p: torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = tree_map(
                lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype), state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(v_.dtype)),
                     state.v, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps)
            u = u + self.weight_decay * p.to(u.dtype)
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamWState(step=step, m=m, v=v)


def global_norm(tree) -> Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac`` of
    it at ``total``; a callable on a step tensor, as the reference's."""
    def lr(step: Tensor) -> Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        t = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


# ---------------------------------------------------- gradient compression
class CompressionState(NamedTuple):
    error: Any  # error-feedback accumulator (same tree as grads)


def compress_init(params) -> CompressionState:
    return CompressionState(
        error=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
    )


@torch.no_grad()
def compress_decompress(grads, cstate: CompressionState, bits: int = 8):
    """Quantize grads to int8 (per-tensor scale) with error feedback.

    Models the wire format of compressed gradient all-reduce: the returned
    grads are exactly what a receiver would reconstruct; the quantization
    residual is carried to the next step (EF-SGD), which keeps convergence.
    """
    qmax = 2.0 ** (bits - 1) - 1

    def one(g, e):
        gf = g.float() + e
        scale = torch.max(torch.abs(gf)) / qmax + 1e-12
        q = torch.clip(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(cstate.error))]
    new_grads = tree_unflatten(grads, [g for g, _ in pairs])
    new_err = tree_unflatten(cstate.error, [e for _, e in pairs])
    return new_grads, CompressionState(error=new_err)
