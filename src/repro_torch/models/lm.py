"""Top-level language model: embeddings, stack(s), head, loss and the serve
steps.

The port of ``repro/models/lm.py`` for decoder-only models of the
attention, MoE, MLA, RWKV6 and RG-LRU kinds (RecurrentGemma's RG-LRU
layers beside local attention), q/k norms and M-RoPE included, and for the
encoder-decoder. Batch dict keys, as in the reference:

  train / forward / prefill: tokens (B,S) int [, labels, positions,
                             enc_embeds, patch_embeds]
  decode:                    token (B,) int, pos (B,) int

An encoder-decoder (SeamlessM4T) takes ``enc_embeds`` (B, S_enc, d) from a
stub speech / text frontend: the encoder stack runs once a call (train,
forward, prefill) and the decoder cross-attends to its output; prefill
caches each layer's cross K/V, which decode reuses and never recomputes.
Without ``enc_embeds`` it fails, as in the reference. A VLM (Qwen2-VL)
takes ``patch_embeds`` (B, P, d) from a stub vision frontend, added into
the first P token slots, and M-RoPE ``positions`` (3, B, S); without them
M-RoPE fails, as in the reference. ``loss`` is the reference's, dense
(float32 logsumexp) or chunked over the vocabulary (``vocab_chunk``), with
``remat`` on the stacks' period layers, plus the MoE layers' aux loss (0
without MoE layers).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.blocks import local_blocks

from .attention_opt import chunked_softmax_xent, gather_last
from .config import ModelConfig
from .layers import Ctx, rmsnorm, rmsnorm_init
from .moe import EPSpec
from .stack import REMAT, _check_kind, stack_apply, stack_init

Params = dict[str, Any]


def _lookup(embed: Tensor, tokens: Tensor) -> Tensor:
    """``embed[tokens]``. On a mesh each rank looks up its batch rows in the
    gathered table (``local_blocks``), the table's gradient partial over
    the DP axes: DTensor's own strategies for the lookup's backward
    (``index_put``) fail in some torch releases."""
    if isinstance(embed, DTensor):
        return local_blocks(lambda e, t: e[t], (embed, tokens), [(None, None), (0, None)],
                            [(0, None)])
    return embed[tokens]


def _gathered(x: Tensor, dim: int) -> Tensor:
    """A DTensor with its ``dim`` whole on every rank: replicated over each
    mesh axis that shards it or holds it as a partial sum (other placements
    kept); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    on = lambda p: p.is_partial() or isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim
    if not any(on(p) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if on(p) else p for p in x.placements])


def _head_operands(params: Params, h: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """The final hidden states (..., d) and the (d, V) head (the tied
    embedding's transpose or ``lm_head``), each with d whole on every rank:
    on a mesh each rank's logits are then its batch rows by its vocabulary
    slice (ZeRO's just-in-time gather of the weight). Left to DTensor, the
    product with a large vocabulary shards d instead and every rank holds
    the whole (B·S, V) logits as a partial sum: 1.1 TB a rank for
    Gemma3-27B's 262 144 tokens at train_4k on the (16, 16) mesh, as the
    dry-run counts it."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _gathered(h, -1), _gathered(w, 0)


def _xent(h: Tensor, w: Tensor, labels: Tensor, chunk: int | None) -> Tensor:
    """Per-token cross entropy (B, S) of the logits ``h @ w``: dense, or
    over static vocabulary chunks (``chunked_softmax_xent``) when ``chunk``
    is set. On a mesh each rank runs its batch rows' slice of the sequence
    over ``model`` against the whole head (``local_blocks``): every
    token's loss is its own, and with the stream whole over ``model``
    every rank of ``model`` would otherwise compute each token's logits (a
    vocabulary that does not divide ``model``, or a chunk of one that
    does, is gathered whole)."""
    if isinstance(h, DTensor):
        return local_blocks(functools.partial(_xent, chunk=chunk), (h, w, labels),
                            [(0, 1), (None, None), (0, 1)], [(0, 1)])
    if chunk is not None:
        return chunked_softmax_xent(h, w, labels, chunk=chunk)
    logits = (h @ w).float()
    return torch.logsumexp(logits, dim=-1) - gather_last(logits, labels)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cuda"
    remat: str = "none"  # "none" | "full" | "dots" (training only)
    attn_impl: str = "naive"  # "naive" | "chunked" (kernel B4) | "stub" (dry-run probe)
    attn_q_blk: int = 1024
    attn_k_blk: int = 1024
    cache_update: str = "onehot"  # decode KV write: "onehot" | "dus"
    vocab_chunk: int | None = None  # chunked CE (no (B,S,V) float32 logits)
    ep: EPSpec | None = None  # the MoE expert-parallel island on a mesh
    pin_mesh: Any = None  # DeviceMesh: batch-sharding pins at attention (O2 and up)
    pin_axes: tuple = ()

    def __post_init__(self):
        cfg = self.cfg
        for kind in cfg.layer_kinds:
            _check_kind(kind)
        if self.attn_impl not in ("naive", "chunked", "stub"):
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of naive, chunked, stub")
        if self.remat not in REMAT:
            raise ValueError(f"remat {self.remat!r} is not one of {REMAT}")

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from ``gen`` (on the model's device), with
        the reference's distributions: N(0, 1/fan_in) projections, N(0, 0.02²)
        embeddings, unit norm scales (RWKV6 blocks: ``rwkv_init``'s); an
        encoder-decoder's encoder stack and its final norm after the rest."""
        cfg, dev = self.cfg, self.device
        embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev).mul_(0.02)
        params: Params = {
            "embed": embed.to(self.dtype),
            "stack": stack_init(gen, cfg, self.dtype, dev),
            "ln_f": rmsnorm_init(cfg.d_model, self.dtype, dev),
        }
        if not cfg.tie_embeddings:
            head = torch.randn((cfg.d_model, cfg.vocab), generator=gen, device=dev).mul_(0.02)
            params["lm_head"] = head.to(self.dtype)
        if cfg.encoder_layers:
            params["encoder"] = {
                "stack": stack_init(gen, self._encoder_cfg(), self.dtype, dev),
                "ln_f": rmsnorm_init(cfg.d_model, self.dtype, dev),
            }
        return params

    # ------------------------------------------------------------ helpers
    def _encoder_cfg(self) -> ModelConfig:
        return dataclasses.replace(
            self.cfg, n_layers=self.cfg.encoder_layers, prefix=(), period=("enc",), suffix=())

    def _run_encoder(self, params: Params, enc_embeds: Tensor) -> Tensor:
        """The encoder stack over the frontend's embeddings, in train mode
        (no cache) under the model's ``remat``, as in the reference."""
        h, _, _ = stack_apply(params["encoder"]["stack"], enc_embeds.to(self.dtype),
                              Ctx(mode="train", ep=self.ep), self._encoder_cfg(),
                              remat=self.remat)
        return rmsnorm(params["encoder"]["ln_f"], h, self.cfg.norm_eps)

    def _with_encoder(self, params: Params, batch: dict) -> dict:
        """``batch`` with the encoder's output under ``_enc_out`` for an
        encoder-decoder, else as it is."""
        if not self.cfg.encoder_layers:
            return batch
        return dict(batch, _enc_out=self._run_encoder(params, batch["enc_embeds"]))

    def _embed(self, params: Params, batch: dict) -> Tensor:
        x = _lookup(params["embed"], batch["tokens"])  # (B,S,d)
        pe = batch.get("patch_embeds")
        if pe is not None:  # the stub vision frontend's patches, first P slots
            x = torch.cat([x[:, :pe.shape[1]] + pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
        return x

    def _head(self, params: Params, h: Tensor) -> Tensor:
        h, w = _head_operands(params, rmsnorm(params["ln_f"], h, self.cfg.norm_eps), self.cfg)
        return h @ w

    def _ctx(self, batch: dict, mode: str, cache_len: int = 0) -> Ctx:
        return Ctx(
            mode=mode,
            positions=batch.get("positions"),
            decode_pos=batch.get("pos"),
            enc_out=batch.get("_enc_out"),
            cache_len=cache_len,
            attn_impl=self.attn_impl,
            attn_q_blk=self.attn_q_blk,
            attn_k_blk=self.attn_k_blk,
            cache_update=self.cache_update,
            ep=self.ep,
            pin_mesh=self.pin_mesh,
            pin_axes=self.pin_axes,
        )

    # -------------------------------------------------------------- train
    def _hidden(self, params: Params, batch: dict) -> tuple[Tensor, Tensor]:
        """The stack's output (B,S,d) in train mode, before the final norm,
        and the MoE layers' aux loss."""
        batch = self._with_encoder(params, batch)
        x = self._embed(params, batch)
        h, _, aux = stack_apply(params["stack"], x, self._ctx(batch, "train"), self.cfg,
                                remat=self.remat)
        return h, aux

    def forward_logits(self, params: Params, batch: dict) -> Tensor:
        """Full-sequence logits (B,S,V). The reference also returns the MoE
        aux loss; here it goes into ``loss`` only (``_hidden`` gives it)."""
        return self._head(params, self._hidden(params, batch)[0])

    def loss(self, params: Params, batch: dict) -> Tensor:
        """Mean next-token cross entropy over all but the last position,
        plus the MoE layers' aux loss.

        ``labels`` default to the tokens shifted left, padded with 0."""
        labels = batch.get("labels")
        if labels is None:
            # the tokens shifted left, 0 last (a concatenation: DTensor's pad
            # mis-places its output in some torch releases)
            tokens = batch["tokens"]
            labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        labels = labels.long()
        h, aux = self._hidden(params, batch)
        # with vocab_chunk set, never the (B,S,V) float32 logits at once
        h, w = _head_operands(params, rmsnorm(params["ln_f"], h, self.cfg.norm_eps), self.cfg)
        ce_tok = _xent(h, w, labels, self.vocab_chunk)
        # last position has no target (a plain tensor: on a mesh, replicated)
        mask = torch.ones(ce_tok.shape, dtype=ce_tok.dtype, device=ce_tok.device)
        mask[:, -1] = 0.0
        return torch.sum(ce_tok * mask) / torch.sum(mask) + aux

    # -------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(
        self, params: Params, batch: dict, cache_len: int | None = None
    ) -> tuple[Tensor, Params]:
        """Returns (last-position logits (B,V), caches). ``cache_len``
        reserves decode capacity beyond the prompt length."""
        batch = self._with_encoder(params, batch)
        x = self._embed(params, batch)
        ctx = self._ctx(batch, "prefill", cache_len or batch["tokens"].shape[1])
        h, caches, _ = stack_apply(params["stack"], x, ctx, self.cfg)
        logits = self._head(params, h[:, -1:, :])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(
        self, params: Params, caches: Params, batch: dict
    ) -> tuple[Tensor, Params]:
        """One token: batch = {token (B,), pos (B,)}. Returns (logits, caches)."""
        x = _lookup(params["embed"], batch["token"])[:, None, :]  # (B,1,d)
        h, new_caches, _ = stack_apply(
            params["stack"], x, self._ctx(batch, "decode"), self.cfg, caches
        )
        return self._head(params, h)[:, 0], new_caches

    # ---------------------------------------------------- cache allocation
    def empty_caches(self, batch_size: int, cache_len: int) -> Params:
        """Zeroed decode caches in the layout ``prefill`` returns."""
        cfg, dev = self.cfg, self.device

        def zeros(shape, dtype=self.dtype) -> Tensor:
            return torch.zeros(shape, dtype=dtype, device=dev)

        def one(kind: str, lead: tuple = ()) -> Params:
            if kind == "rwkv":
                n_h, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
                return {
                    "state": zeros(lead + (batch_size, n_h, hs, hs), torch.float32),
                    "shift_tm": zeros(lead + (batch_size, cfg.d_model)),
                    "shift_cm": zeros(lead + (batch_size, cfg.d_model)),
                }
            if kind == "rglru":  # the float32 state and the conv's carried tail
                lru = cfg.lru_width or cfg.d_model
                return {"h": zeros(lead + (batch_size, lru), torch.float32),
                        "conv": zeros(lead + (batch_size, cfg.conv_width - 1, lru))}
            if kind.startswith("mla"):  # the compressed (c_kv, k_pe) cache
                m = cfg.mla
                return {"self": {"ckv": zeros(lead + (batch_size, cache_len, m.kv_lora_rank)),
                                 "kpe": zeros(lead + (batch_size, cache_len, m.rope_head_dim))}}
            s = cache_len if kind != "local" else min(cache_len, cfg.window)
            kv = lambda n: {"k": zeros(lead + (batch_size, n, cfg.n_kv_heads, cfg.head_dim_)),
                            "v": zeros(lead + (batch_size, n, cfg.n_kv_heads, cfg.head_dim_))}
            if kind == "xattn":
                return {"self": kv(s), "cross": kv(cfg.encoder_seq)}
            return {"self": kv(s)}

        caches: Params = {
            "prefix": [one(kind) for kind in cfg.prefix],
            "period": None,
            "suffix": [one(kind) for kind in cfg.suffix],
        }
        if cfg.n_periods > 0:
            caches["period"] = tuple(one(kind, (cfg.n_periods,)) for kind in cfg.period)
        return caches
