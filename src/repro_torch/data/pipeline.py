"""Synthetic data pipeline: deterministic, seekable, host-shardable.

The port of ``repro/data/pipeline.py``. It produces next-token-predictable
synthetic streams so training loss measurably decreases, with no external
dataset: each row starts at a token uniform in the vocabulary and steps by
a stride uniform in 1..6, ``(start + stride * t) % vocab``, and 2 % of the
tokens are replaced by uniform ones. JAX's threefry streams cannot be
reproduced in torch, so the draws differ from the reference's; the stream's
law is the same. Batch ``step`` is drawn on the host from its own
``torch.Generator``, seeded with ``(seed, step)`` mixed by numpy's
``SeedSequence`` (the generator keeps 32 bits of a seed), then moved to
``device``, so ``batch_at`` is seekable and the same on every device, which is what
resuming after a restore needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str | torch.device = "cuda"

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given step (seekable)."""
        if step < 0:
            raise ValueError(f"step {step} is negative")
        seed = np.random.SeedSequence([self.seed, step]).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(seed))
        b, s = self.global_batch, self.seq_len
        start = torch.randint(0, self.vocab, (b, 1), generator=gen)
        stride = torch.randint(1, 7, (b, 1), generator=gen)
        toks = (start + stride * torch.arange(s)[None, :]) % self.vocab
        flip = torch.rand((b, s), generator=gen) < 0.02
        rand = torch.randint(0, self.vocab, (b, s), generator=gen)
        toks = torch.where(flip, rand, toks)
        return {"tokens": toks.to(torch.int32).to(self.device)}

    def iterate(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1
