"""Causal / sliding-window GQA flash attention: a CUDA kernel, its plain twin
and a gradient.

Attention for q (B, Tq, H, hd) against k (B, Tk, KH, hd) and v
(B, Tk, KH, vd), with GQA groups G = H / KH: query head ``h`` reads KV head
``h // G``. The output is (B, Tq, H, vd).

    s[iq, ik] = (q[iq] . k[ik]) * scale        (accumulated in float32)
    masked    = not (ik <= iq if causal) or not (ik > iq - window if window)
    out[iq]   = softmax over ik of s, masked scores set to NEG = -1e30

The reference's Pallas kernel takes one width (vd = hd). Its lax
``chunked_sdpa``, which this kernel stands for on the model path, takes a v
width of its own, and MLA (DeepSeek-V3) runs hd = 192 against vd = 128; so
the kernel is built for the width pairs in ``HEAD_DIMS``, RecurrentGemma's
hd = vd = 256 among them (there a pair of warps shares each row group's
width). :func:`kernel_plan` reads an instance's tile, shared memory and
blocks an SM from the library.

Indices are absolute from 0, so Tq != Tk is allowed. Keys are padded with
zeros to a multiple of ``k_blk``; a padded key is masked only by the causal
test, as in the reference (its indices exceed every query index when
Tq <= Tk). A row whose every key is masked gets the mean of the padded
values, which is what an online softmax over all-NEG scores leaves.

* :func:`flash_attention_cuda` (kernel B4) launches the hand-written Hopper
  kernel in ``csrc/flash_attention.cu``. It replaces the Pallas TPU kernel
  ``repro/kernels/flash_attention.py::flash_attention_pallas``. The library
  is built with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at first
  launch and loaded with ``ctypes``; the function adds one to its
  ``launches`` count per launch.
* :func:`flash_attention_plain` is its plain twin: the reference kernel's
  online softmax (m, l, acc) over k blocks in eager PyTorch, with the same
  NEG, clamp and padding rules. It runs for CPU tensors, and on the card
  only to check the kernel.
* :func:`flash_attention` keeps the reference's block rules and dispatches
  on where the tensors live. There is no fallback from one to the other.
  It is a ``torch.autograd.Function``: the forward is kernel B4 or the
  plain twin, and the backward is :func:`flash_attention_backward`.
* :func:`flash_attention_backward` gives dq, dk and dv in torch ops, the
  same code on both devices, as XLA differentiates the reference's
  ``chunked_sdpa``: over key blocks it recomputes the row max and sum from
  q . k^T, then per block P, dV = P^T dO, dS = P o (dO V^T - rowsum(dO o O)),
  dQ += dS K scale and dK = dS^T Q scale, each summed over its GQA group,
  under the forward's causal, window and padding masks. The reference has
  no backward kernel, so none is written here.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

from ._build import build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NEG = -1e30
# (q/k width, v width) pairs the kernel is instantiated for
HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
MAX_GROUP = 128  # the kernel's block holds 128 query rows of one KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    lib = build_library(SOURCE)
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_plan.restype = ctypes.c_int
    return lib


def kernel_plan(hd: int, vd: int, dtype: torch.dtype) -> dict:
    """The design of B4's (hd, vd) instance for ``dtype`` on the current
    card: keys per shared-memory tile, dynamic shared memory a block
    (bytes), threads a block, the blocks an SM it is built for and the
    blocks an SM the runtime grants it. Builds the library; needs a card."""
    plan = (ctypes.c_int * 5)()
    err = load_library().flash_attention_plan(hd, vd, _DTYPES[dtype], plan)
    if err != 0:
        raise RuntimeError(f"flash_attention_plan({hd}, {vd}) failed: cudaError_t {err}")
    return dict(zip(("key_tile", "smem_bytes", "threads", "blocks_per_sm",
                     "granted_blocks_per_sm"), plan))


def _blocks(q: Tensor, k: Tensor, v: Tensor, causal: bool, k_blk: int) -> int:
    """The reference's shape contract and padding rules; returns the padded
    key length."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"need q (B,Tq,H,hd), k (B,Tk,KH,hd), v (B,Tk,KH,vd); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, tq, h, hd = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd or h % kh:
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H must be a multiple of KH)"
        )
    k_blk = min(k_blk, tk)
    pad_k = (-tk) % k_blk if k_blk else 0
    if not causal and pad_k:
        raise ValueError("non-causal padding needs an explicit length mask")
    return tk + pad_k


def flash_attention_plain(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    q_blk: int = 512,
    k_blk: int = 512,
) -> Tensor:
    """The reference kernel's function in eager PyTorch, on any device.

    An online softmax over k blocks of ``min(k_blk, Tk)`` keys, all queries
    at once (the q blocks of the reference only tile the same rows).
    """
    tkp = _blocks(q, k, v, causal, k_blk)
    b, tq, h, hd = q.shape
    tk, kh, vd = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    k_blk = min(k_blk, tk)
    if tkp > tk:
        pad = (0, 0, 0, 0, 0, tkp - tk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    qg = q.reshape(b, tq, kh, g, hd)
    m = torch.full((b, kh, g, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, tq, vd), dtype=torch.float32, device=q.device)
    iq = torch.arange(tq, device=q.device)[:, None]
    for k0 in range(0, tkp, k_blk):
        kb, vb = k[:, k0:k0 + k_blk], v[:, k0:k0 + k_blk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kb.float()) * scale
        ik = torch.arange(k0, k0 + k_blk, device=q.device)[None, :]
        mask = torch.ones((tq, k_blk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ik <= iq
        if window is not None:
            mask &= ik > iq - window
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, vd).to(q.dtype)


def flash_attention_cuda(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    k_pad: int = 0,
) -> Tensor:
    """Kernel B4 on the current stream; no synchronise.

    ``k_pad`` zero keys are appended to k/v (the reference's block padding).
    Inputs must be contiguous float32 or bfloat16 CUDA tensors of one dtype
    on one device, with (hd, vd) in ``HEAD_DIMS`` and G = H / KH at most
    ``MAX_GROUP``; any other width pair raises.
    """
    b, tq, h, hd = q.shape
    tk, kh, vd = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != hd or h % kh:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if (hd, vd) not in HEAD_DIMS:
        raise ValueError(f"head widths (q/k {hd}, v {vd}) are not a pair the kernel takes: "
                         f"{HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected one CUDA device")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {x.dtype}; need float32 or bfloat16, all alike")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h // kh > MAX_GROUP:
        raise ValueError(f"GQA group {h // kh} exceeds the kernel's {MAX_GROUP}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    out = q.new_empty((b, tq, h, vd))
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, tk + k_pad, h, kh, hd, vd, _DTYPES[q.dtype], float(scale),
            int(causal), 0 if window is None else 1, 0 if window is None else int(window),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    flash_attention_cuda.launches += 1
    return out


def _flash_forward(q, k, v, scale, causal, window, q_blk, k_blk) -> Tensor:
    tkp = _blocks(q, k, v, causal, k_blk)
    if q.is_cuda:
        return flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(),
            scale=scale, causal=causal, window=window, k_pad=tkp - k.shape[1],
        )
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, scale=scale, causal=causal, window=window, q_blk=q_blk, k_blk=k_blk
        )
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")


def flash_attention_backward(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    out: Tensor,
    dout: Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    k_blk: int = 512,
) -> tuple[Tensor, Tensor, Tensor]:
    """dq, dk, dv of :func:`flash_attention` at ``out`` for the cotangent
    ``dout``, in float32 over key blocks of ``min(k_blk, Tk)`` keys (all
    queries at once), cast to the inputs' dtypes.

    Keys are zero-padded as in the forward, and every score the forward
    masked (NEG) gets no gradient; a row whose every key is masked spreads
    its weight evenly over all keys, as the forward's online softmax does.
    """
    tkp = _blocks(q, k, v, causal, k_blk)
    b, tq, h, hd = q.shape
    tk, kh, vd = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    k_blk = min(k_blk, tk)
    kf, vf = k.float(), v.float()
    if tkp > tk:
        pad = (0, 0, 0, 0, 0, tkp - tk)
        kf, vf = torch.nn.functional.pad(kf, pad), torch.nn.functional.pad(vf, pad)
    qg = q.float().reshape(b, tq, kh, g, hd)
    dog = dout.float().reshape(b, tq, kh, g, vd)
    # rowsum(dO o O), (b, kh, g, tq)
    delta = (dog * out.float().reshape(b, tq, kh, g, vd)).sum(-1).permute(0, 2, 3, 1)
    iq = torch.arange(tq, device=q.device)[:, None]

    def scores(k0: int) -> tuple[Tensor, Tensor]:
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf[:, k0:k0 + k_blk]) * scale
        ik = torch.arange(k0, k0 + k_blk, device=q.device)[None, :]
        mask = torch.ones((tq, k_blk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ik <= iq
        if window is not None:
            mask &= ik > iq - window
        return torch.where(mask, s, NEG), mask

    m = torch.full((b, kh, g, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=q.device)
    for k0 in range(0, tkp, k_blk):
        s, _ = scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    l = torch.clamp_min(l, 1e-30)

    dq = torch.zeros_like(qg)
    dk = torch.empty((b, tkp, kh, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, tkp, kh, vd), dtype=torch.float32, device=q.device)
    for k0 in range(0, tkp, k_blk):
        s, mask = scores(k0)
        p = torch.exp(s - m[..., None]) / l[..., None]
        dv[:, k0:k0 + k_blk] = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf[:, k0:k0 + k_blk])
        ds = torch.where(mask, p * (dp - delta[..., None]), 0.0) * scale
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds, kf[:, k0:k0 + k_blk])
        dk[:, k0:k0 + k_blk] = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return (dq.reshape(b, tq, h, hd).to(q.dtype), dk[:, :tk].to(k.dtype),
            dv[:, :tk].to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_blk, k_blk):
        out = _flash_forward(q, k, v, scale, causal, window, q_blk, k_blk)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(scale=scale, causal=causal, window=window, k_blk=k_blk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    q_blk: int = 512,
    k_blk: int = 512,
) -> Tensor:
    """q (B,Tq,H,hd), k (B,Tk,KH,hd), v (B,Tk,KH,vd) -> (B,Tq,H,vd), where
    the tensors live.

    Block sizes follow the reference: ``q_blk = min(q_blk, Tq)``,
    ``k_blk = min(k_blk, Tk)``, keys padded to a multiple of ``k_blk``, and
    ``ValueError`` for non-causal attention that would need key padding.
    CUDA tensors launch kernel B4 (which tiles by its own sizes and skips
    key tiles outside the causal / window band); CPU tensors run
    :func:`flash_attention_plain`. Under autograd the result has a
    ``grad_fn`` whose backward is :func:`flash_attention_backward`.
    """
    return _FlashAttention.apply(q, k, v, float(scale), causal, window, q_blk, k_blk)


flash_attention_cuda.launches = 0
