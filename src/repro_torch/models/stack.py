"""Layer-stack machinery: blocks and the prefix / period / suffix stack.

The port of ``repro/models/stack.py`` for the attention kinds (``attn``,
``dense``, ``local``), ``moe`` (attention + the MoE MLP on its local
path), DeepSeek's ``mla`` (MLA + the MoE MLP) and ``mla_dense`` (MLA + a
dense MLP), the encoder-decoder's ``enc`` (bidirectional self-attention)
and ``xattn`` (causal self-attention, then cross-attention over the
encoder memory) kinds, ``rwkv`` (the RWKV6 block, which owns its
residuals) and ``rglru`` (pre-norm residual RG-LRU, then the dense MLP):
every kind the reference has.
The parameter tree is the reference's: ``prefix``
and ``suffix`` are lists of blocks, and ``period`` is a list with one entry
per position of the repeating pattern, each stacked on a leading
``n_periods`` axis, so weights carry across one for one. Where the
reference scans the period with ``lax.scan``, the port walks the layers in
a Python loop and stacks each period position's caches on the same leading
axis. In training, ``remat`` acts on each period layer as the reference's
acts on its scan body: ``"full"`` recomputes the layer in the backward
(``torch.utils.checkpoint``, non-reentrant) and ``"dots"`` keeps only the
outputs of its plain matrix products (``aten.mm`` / ``addmm``, the dots
with no batch dimensions that ``checkpoint_dots_with_no_batch_dims`` keeps)
and recomputes the rest. The MoE layers' aux losses are summed over
prefix, period and suffix and returned beside the output, as the
reference's third value. A kind the reference does not have raises
``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch import Tensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.distributed.blocks import grad_placed, placed_like, split_last

from .config import ModelConfig
from .layers import (
    Ctx,
    _sdpa,
    apply_rope,
    attn_apply,
    attn_init,
    mla_apply,
    mla_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    rope_angles,
)
from .moe import moe_apply, moe_init
from .rglru import rglru_apply, rglru_init
from .rwkv6 import rwkv_apply, rwkv_init

Params = dict[str, Any]
PORTED_KINDS = ("attn", "dense", "local", "moe", "mla", "mla_dense", "enc", "xattn", "rwkv",
                "rglru")
REMAT = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _mlp_kind(kind: str) -> str:
    """The block's MLP: "moe" for ``moe`` and ``mla``, else "dense"."""
    return "moe" if kind in ("moe", "mla") else "dense"


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not a kind of the reference; "
            f"the port runs {PORTED_KINDS}"
        )


def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype, device) -> Params:
    _check_kind(kind)
    d = cfg.d_model
    if kind == "rwkv":
        return {"rwkv": rwkv_init(gen, cfg, dtype, device)}
    if kind == "rglru":
        return {
            "ln1": rmsnorm_init(d, dtype, device),
            "rglru": rglru_init(gen, cfg, dtype, device),
            "ln2": rmsnorm_init(d, dtype, device),
            "mlp": mlp_init(gen, d, cfg.d_ff, dtype, device),
        }
    attn = mla_init if kind.startswith("mla") else attn_init
    p = {
        "ln1": rmsnorm_init(d, dtype, device),
        "ln2": rmsnorm_init(d, dtype, device),
        "attn": attn(gen, cfg, dtype, device),
    }
    if kind == "xattn":
        p["ln_x"] = rmsnorm_init(d, dtype, device)
        p["xattn"] = attn_init(gen, cfg, dtype, device)
    if _mlp_kind(kind) == "moe":
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, device)
    return p


def block_apply(
    p: Params,
    kind: str,
    x: Tensor,
    ctx: Ctx,
    cfg: ModelConfig,
    cache: Params | None,
) -> tuple[Tensor, Params | None, Tensor]:
    """Pre-norm residual attention (GQA or MLA) + dense or MoE MLP block
    (``xattn`` adds pre-norm residual cross-attention between the two), the
    RWKV6 block, or pre-norm residual RG-LRU + dense MLP. Returns (x,
    new_cache, aux loss), the aux a float 0.0 for a dense MLP.

    On a mesh the residual stream keeps its placements (the embedding's:
    the batch over the DP axes, whole over ``model``): a sub-block's
    output, partial over ``model`` where its last product sums over a dim
    split there, is placed as the stream before the add (``placed_like``),
    and the gradient of a sub-block's input comes back at the input's
    placements (``grad_placed``). Left to DTensor, the stream turns partial
    or split on d at no cost, and the next norm reduce-scatters it over the
    sequence, so that every product after it merges a strided shard."""
    _check_kind(kind)
    if kind == "rwkv":
        x, new_cache = rwkv_apply(p["rwkv"], x, cfg, ctx.mode, cache)
        return x, new_cache, 0.0

    def norm(name: str, x: Tensor) -> Tensor:
        return grad_placed(rmsnorm(p[name], x, cfg.norm_eps))

    if kind == "rglru":
        y, new_cache = rglru_apply(p["rglru"], norm("ln1", x), ctx.mode, cache)
        x = x + placed_like(y, x)
        return x + placed_like(mlp_apply(p["mlp"], norm("ln2", x)), x), new_cache, 0.0
    self_cache = cache.get("self") if cache else None
    h = norm("ln1", x)
    if kind == "enc":
        # bidirectional; enc blocks only run in full-sequence mode, no cache
        y, new_self = _bidirectional_attn(p["attn"], h, cfg), None
    elif kind.startswith("mla"):
        y, new_self = mla_apply(p["attn"], h, ctx, cfg, cache=self_cache)
    else:
        window = cfg.window if kind == "local" else None
        y, new_self = attn_apply(p["attn"], h, ctx, cfg, window=window, cache=self_cache)
    x = x + placed_like(y, x)
    new_cache = None
    if kind == "xattn":
        yx, new_cross = attn_apply(p["xattn"], norm("ln_x", x), ctx, cfg,
                                   cache=cache.get("cross") if cache else None, cross=True)
        x = x + placed_like(yx, x)
        if new_self is not None or new_cross is not None:
            new_cache = {"self": new_self, "cross": new_cross}
    elif new_self is not None:
        new_cache = {"self": new_self}
    h = norm("ln2", x)
    if _mlp_kind(kind) == "moe":
        y, aux = moe_apply(p["moe"], h, cfg, ctx.ep)
    else:
        y, aux = mlp_apply(p["mlp"], h), 0.0  # no launch for a zero
    return x + placed_like(y, x), new_cache, aux


def _bidirectional_attn(p: Params, h: Tensor, cfg: ModelConfig) -> Tensor:
    """Full (non-causal) self-attention for encoder blocks: RoPE over the
    whole head width (not ``rotary_pct``), the naive ``_sdpa`` with an
    all-true mask, as in the reference."""
    b, t, _ = h.shape
    hh, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = split_last(h @ p["wq"], hh, hd)
    k = split_last(h @ p["wk"], kh, hd)
    v = split_last(h @ p["wv"], kh, hd)
    pos = torch.arange(t, device=h.device)[None, :].expand(b, t)
    cos, sin = rope_angles(pos, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    mask = torch.ones((b, t, t), dtype=torch.bool, device=h.device)
    y = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    return y.reshape(b, t, hh * hd) @ p["wo"]


def _stack_trees(trees: list):
    """Stack a list of like-shaped trees on a new leading axis. The trees
    are consumed: each leaf leaves its tree as it is stacked, and a single
    tree's leaves become views, so no more than one leaf is ever held twice
    (one period of DeepSeek-V3's expert leaves is 45 GB in float32)."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _stack_trees([t.pop(key) for t in trees]) for key in list(first)}
    return torch.stack(trees) if len(trees) > 1 else trees[0].unsqueeze(0)


def _unstack(tree) -> list:
    """The entries of a tree stacked on its leading axis, one tree each.
    One ``unbind`` a leaf, so a backward stacks each leaf's gradient once
    (indexing the stack layer by layer would zero-fill a full-size gradient
    a layer)."""
    if isinstance(tree, dict):
        cols = {key: _unstack(val) for key, val in tree.items()}
        n = len(next(iter(cols.values())))
        return [{key: col[i] for key, col in cols.items()} for i in range(n)]
    return list(torch.unbind(tree))


# ------------------------------------------------------------------- stack
def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    """Blocks drawn in order from ``gen``: prefix, period (position by
    position, each over its ``n_periods`` layers), suffix."""
    params: Params = {"prefix": [], "suffix": []}
    for kind in cfg.prefix:
        params["prefix"].append(block_init(gen, kind, cfg, dtype, device))
    if cfg.n_periods > 0:
        params["period"] = [
            _stack_trees([block_init(gen, kind, cfg, dtype, device)
                          for _ in range(cfg.n_periods)])
            for kind in cfg.period
        ]
    for kind in cfg.suffix:
        params["suffix"].append(block_init(gen, kind, cfg, dtype, device))
    return params


def _period_layer(p_rows: list, x: Tensor, ctx: Ctx, cfg: ModelConfig, c_rows) -> tuple:
    """One layer of the period: each position's block in turn. Returns (x,
    the positions' caches, the layer's aux loss)."""
    ncs = []
    aux = 0.0
    for pos, kind in enumerate(cfg.period):
        x, nc, a = block_apply(p_rows[pos], kind, x, ctx, cfg, c_rows[pos] if c_rows else None)
        aux = aux + a
        ncs.append(nc)
    return x, ncs, aux


def _remat_layer(p_rows: list, x: Tensor, ctx: Ctx, cfg: ModelConfig,
                 remat: str) -> tuple[Tensor, Tensor]:
    """A training period layer under ``remat`` "full" or "dots": (x, aux)."""
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if remat == "dots" else noop_context_fn)

    def layer(x, p):
        x, _, aux = _period_layer(p, x, ctx, cfg, None)
        return x, aux

    return checkpoint(layer, x, p_rows, use_reentrant=False, context_fn=context_fn)


def stack_apply(
    params: Params,
    x: Tensor,
    ctx: Ctx,
    cfg: ModelConfig,
    caches: Params | None = None,
    remat: str = "none",
) -> tuple[Tensor, Params | None, Tensor]:
    """Run the full stack. Returns (x, new_caches, aux loss sum); caches
    only in prefill and decode, in the reference's layout. ``remat`` (one
    of ``REMAT``) acts in train mode only."""
    want_cache = ctx.mode in ("prefill", "decode")
    new_caches: Params = {"prefix": [], "period": None, "suffix": []}
    aux = 0.0  # a tensor once an MoE layer adds to it

    for i, kind in enumerate(cfg.prefix):
        c = caches["prefix"][i] if caches else None
        x, nc, a = block_apply(params["prefix"][i], kind, x, ctx, cfg, c)
        aux = aux + a
        new_caches["prefix"].append(nc)

    if cfg.n_periods > 0:
        rows: list[list] = [[] for _ in cfg.period]
        p_layers = [_unstack(p) for p in params["period"]]
        c_layers = [_unstack(c) for c in caches["period"]] if caches else None
        for layer in range(cfg.n_periods):
            p_rows = [p[layer] for p in p_layers]
            if remat != "none" and ctx.mode == "train":
                x, a = _remat_layer(p_rows, x, ctx, cfg, remat)
                aux = aux + a
                continue
            c_rows = [c[layer] for c in c_layers] if c_layers else None
            x, ncs, a = _period_layer(p_rows, x, ctx, cfg, c_rows)
            aux = aux + a
            for pos, nc in enumerate(ncs):
                rows[pos].append(nc)
        if want_cache:
            new_caches["period"] = tuple(_stack_trees(r) for r in rows)

    for i, kind in enumerate(cfg.suffix):
        c = caches["suffix"][i] if caches else None
        x, nc, a = block_apply(params["suffix"][i], kind, x, ctx, cfg, c)
        aux = aux + a
        new_caches["suffix"].append(nc)

    if not torch.is_tensor(aux):
        aux = x.new_zeros((), dtype=torch.float32)
    return x, (new_caches if want_cache else None), aux
