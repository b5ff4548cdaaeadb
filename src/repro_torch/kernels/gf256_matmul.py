"""GF(2^8) matrix product for the erasure codec: CUDA kernels and plain twins.

C = A @GF B on uint8, with XOR as the field's addition and the product
reduced by ``POLY`` = 0x11d. Reed-Solomon encode is an (n-k, k) x (k, bytes)
product; a batch of degraded-read decodes is (B, k, k) x (B, k, bytes).

* :func:`gf256_matmul_cuda` (kernel B2) and :func:`gf256_matmul_batched_cuda`
  (kernel B3) launch the hand-written Hopper kernel in
  ``csrc/gf256_matmul.cu``: row-packed product tables in shared memory
  (:func:`packed_product_tables` is what each block builds), one 8-byte
  lookup per column and k, aligned 16-byte loads and stores whatever the
  rows' alignment, a persistent grid. They replace the Pallas TPU kernels
  ``repro/kernels/gf256_matmul.py::gf256_matmul_pallas`` and
  ``gf256_matmul_pallas_batched``. The TPU's block-size choice
  (``select_block_sizes``) reasons about VMEM and is not ported; the CUDA
  kernel fixes its own tiling. The library is built with ``nvcc`` for
  ``sm_90a`` into ``build/repro_torch/`` at first launch and loaded with
  ``ctypes``. Each adds one to its own ``launches`` count per call (a call
  with M > 8 or K > 7 runs as several passes of the kernel).
* :func:`gf256_matmul_plain` and :func:`gf256_matmul_batched_plain` are
  their plain twins: the K-scan of 8-round xtime multiplies that the TPU
  kernel's ``_gf_mul_tile`` runs. GF(256) arithmetic is exact, so table
  lookups and xtime give the same bytes and the kernels are held to the
  twins bitwise.

``repro_torch.kernels.ops`` dispatches between them by where the tensors
live. The launch functions take contiguous uint8 CUDA tensors only and
raise on anything else; they never fall back to a plain twin.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

from repro_torch.storage.gf256 import gf_matmul_ref, gf_mul_xtime

from ._build import build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf256_matmul.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib = build_library(SOURCE)
    ptrs = [ctypes.c_void_p] * 3
    lib.gf256_matmul_launch.argtypes = (
        ptrs + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    lib.gf256_matmul_batched_launch.argtypes = (
        ptrs + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    lib.gf256_matmul_launch.restype = ctypes.c_int
    lib.gf256_matmul_batched_launch.restype = ctypes.c_int
    return lib


def _check(a: Tensor, b: Tensor, ndim: int) -> None:
    """Shape contract of the plain twins: (.., M, K) x (.., K, N), uint8."""
    if a.dim() != ndim or b.dim() != ndim:
        raise ValueError(
            f"need {ndim}-d operands, got {tuple(a.shape)} x {tuple(b.shape)}"
        )
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shapes do not chain: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise ValueError(f"need uint8 operands, got {a.dtype} x {b.dtype}")


def gf256_matmul_plain(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) @GF (K, N) -> (M, N): the K-scan of xtime multiplies."""
    _check(a, b, 2)
    return gf_matmul_ref(a, b)


def gf256_matmul_batched_plain(a: Tensor, b: Tensor) -> Tensor:
    """(B, M, K) @GF (B, K, N) -> (B, M, N): the same K-scan, batched."""
    _check(a, b, 3)
    return gf_matmul_ref(a, b)


def packed_product_tables(a: Tensor) -> Tensor:
    """The kernel's row-packed product tables for one pass of A (M, K), M <= 8:
    (K, 256) int64 whose entry [k, e] holds A[i, k] * e in byte i, for
    every byte e. A column j of C = A @GF B is then the XOR over k of
    entry [k, B[k, j]], row i in byte i."""
    m, k = a.shape
    if m > 8:
        raise ValueError(f"a pass packs at most 8 rows, got {m}")
    prods = gf_mul_xtime(a.T[:, :, None], torch.arange(256, dtype=torch.uint8, device=a.device))
    shifts = 8 * torch.arange(m, device=a.device)[:, None]
    return (prods.long() << shifts).sum(dim=1)


def _launch_checks(a: Tensor, b: Tensor, ndim: int) -> None:
    _check(a, b, ndim)
    if not a.is_cuda or b.device != a.device:
        raise ValueError(f"need both operands on one CUDA device, got {a.device} and {b.device}")
    for name, x in (("a", a), ("b", b)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() == 0:
            raise ValueError(f"{name} is empty, shape {tuple(x.shape)}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def gf256_matmul_cuda(a: Tensor, b: Tensor) -> Tensor:
    """Kernel B2: (M, K) @GF (K, N) on the current stream; no synchronise."""
    _launch_checks(a, b, 2)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.uint8, device=a.device)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gf256_matmul_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream
        )
    _raise_on(err, "gf256_matmul")
    gf256_matmul_cuda.launches += 1
    return out


def gf256_matmul_batched_cuda(a: Tensor, b: Tensor) -> Tensor:
    """Kernel B3: (B, M, K) @GF (B, K, N) on the current stream; no synchronise."""
    _launch_checks(a, b, 3)
    (bsz, m, k), n = a.shape, b.shape[2]
    out = torch.empty((bsz, m, n), dtype=torch.uint8, device=a.device)
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gf256_matmul_batched_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, m, k, n, stream
        )
    _raise_on(err, "gf256_matmul_batched")
    gf256_matmul_batched_cuda.launches += 1
    return out


gf256_matmul_cuda.launches = 0
gf256_matmul_batched_cuda.launches = 0
