"""Public entry points for the GF(256) compute layer.

Three interchangeable backends, all bit-exact:

* ``cuda``     — the hand-written Hopper kernels B2 (unbatched) and B3
                 (batched) in :mod:`.gf256_matmul`. CUDA tensors only.
* ``bitplane`` — expand each GF(256) constant into its 8x8 GF(2)
                 bit-matrix (Cauchy/Jerasure technique) so the whole GF
                 matmul becomes ONE 0/1 matmul of shape (8M, 8K) x (8K, N)
                 followed by a parity (&1). It runs in float32 through
                 ``torch.matmul``, which is exact: every sum is at most 8K.
                 The reference computes it outside Pallas too. Its lifted
                 operand is 8x the bytes of B, so nothing on the codec's
                 main path selects it.
* ``ref``      — the kernels' plain twins, the K-scan of xtime multiplies
                 (the reference's ``ref`` backend is the same K-scan).

``auto`` picks ``cuda`` for CUDA tensors and ``ref`` for CPU tensors. The
reference's ``auto`` picks ``bitplane`` on a TPU, an XLA integer matmul
that never reaches its Pallas kernel; copied faithfully, the card's path
would go to ``torch.matmul`` and never run kernels B2 and B3. There is no
``pallas`` backend here: it and any other name raise ``ValueError``.

The dispatchers, not the kernels, take the edge cases the reference
accepts. A product with an empty extent is answered without a launch:
M, N or the batch 0 gives the empty result, K = 0 gives zeros (an n == k
code has a (0, k) parity matrix; an empty payload splits into (k, 0)
rows). Operands are made contiguous before a launch, so a sliced view
works as it does in the reference; the launchers stay strict.
"""
from __future__ import annotations

import functools

import torch
from torch import Tensor

from repro_torch.storage import rs
from repro_torch.storage.gf256 import bytes_to_bits, gf_const_to_bitmatrix

from .gf256_matmul import (
    _check,
    gf256_matmul_batched_cuda,
    gf256_matmul_batched_plain,
    gf256_matmul_cuda,
    gf256_matmul_plain,
)

BACKENDS = ("ref", "bitplane", "cuda")


def _resolve(backend: str, x: Tensor) -> str:
    if backend == "auto":
        return "cuda" if x.is_cuda else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have auto, {', '.join(BACKENDS)}")
    return backend


def _empty_product(a: Tensor, b: Tensor, ndim: int) -> Tensor | None:
    """The result of a product with an empty extent, or None if it has none:
    an empty (.., M, N) for M, N or a batch of 0, and zeros for K = 0."""
    _check(a, b, ndim)
    if a.numel() and b.numel():
        return None
    return torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.uint8, device=a.device)


def _parity_to_bytes(c_bits: Tensor) -> Tensor:
    """(..., M, 8, N) float sums -> (..., M, N) uint8 from their parities."""
    bits = c_bits.to(torch.int32) & 1
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)[:, None]
    return (bits << shifts).sum(dim=-2).to(torch.uint8)


def gf256_matmul_bitplane(a: Tensor, b: Tensor) -> Tensor:
    """C = A @GF B via GF(2) bit-matrix lifting.

    bits(C[i,j])_p = sum_{k,q} M_{A[i,k]}[p,q] * bits(B[k,j])_q  (mod 2)
    """
    m, k = a.shape
    n = b.shape[1]
    big_a = gf_const_to_bitmatrix(a)  # (M, K, 8, 8) [p, q] order
    big_a = big_a.permute(0, 2, 1, 3).reshape(m * 8, k * 8)  # (8M, 8K)
    big_b = bytes_to_bits(b.T).permute(1, 2, 0).reshape(k * 8, n)  # (8K, N)
    c_bits = torch.matmul(big_a.float(), big_b.float())  # (8M, N)
    return _parity_to_bytes(c_bits.reshape(m, 8, n))


def gf256_matmul(a: Tensor, b: Tensor, *, backend: str = "auto") -> Tensor:
    """Dispatching GF(256) matmul (M, K) x (K, N); bit-exact across backends."""
    a = torch.as_tensor(a, dtype=torch.uint8)
    b = torch.as_tensor(b, dtype=torch.uint8)
    backend = _resolve(backend, a)
    empty = _empty_product(a, b, 2)
    if empty is not None:
        return empty
    if backend == "cuda":
        return gf256_matmul_cuda(a.contiguous(), b.contiguous())
    if backend == "ref":
        return gf256_matmul_plain(a, b)
    return gf256_matmul_bitplane(a, b)


# --- the batched (B, k, bytes) contract ------------------------------------
#
# One call, B independent GF matmuls: C[b] = A[b] @GF B[b]. This is the
# codec pipeline's shape — a decode-matrix bank (B, k, k) against gathered
# chunk payloads (B, k, bytes) — and every backend accepts it bit-exactly:
#
#   * ref      — the K-scan with the batch as a leading axis,
#   * bitplane — ONE batched 0/1 matmul of the bit-lifted operands,
#   * cuda     — kernel B3, the batch as the grid's y axis.


def gf256_matmul_batch_bitplane(a: Tensor, b: Tensor) -> Tensor:
    """Batched bit-plane path: per-element GF(2) lifting, one batched matmul.

    bits(C[v,i,j])_p = sum_{k,q} M_{A[v,i,k]}[p,q] * bits(B[v,k,j])_q (mod 2)
    """
    bsz, m, k = a.shape
    n = b.shape[2]
    big_a = gf_const_to_bitmatrix(a)  # (B, M, K, 8, 8) [p, q]
    big_a = big_a.permute(0, 1, 3, 2, 4).reshape(bsz, m * 8, k * 8)
    big_b = bytes_to_bits(b.transpose(1, 2))  # (B, N, K, 8)
    big_b = big_b.permute(0, 2, 3, 1).reshape(bsz, k * 8, n)
    c_bits = torch.matmul(big_a.float(), big_b.float())  # (B, 8M, N)
    return _parity_to_bytes(c_bits.reshape(bsz, m, 8, n))


def gf256_matmul_batch(a: Tensor, b: Tensor, *, backend: str = "auto") -> Tensor:
    """C (B,M,N) = A (B,M,K) @GF B (B,K,N); bit-exact across backends."""
    a = torch.as_tensor(a, dtype=torch.uint8)
    b = torch.as_tensor(b, dtype=torch.uint8)
    backend = _resolve(backend, a)
    empty = _empty_product(a, b, 3)
    if empty is not None:
        return empty
    if backend == "cuda":
        return gf256_matmul_batched_cuda(a.contiguous(), b.contiguous())
    if backend == "ref":
        return gf256_matmul_batched_plain(a, b)
    return gf256_matmul_batch_bitplane(a, b)


def rs_encode(data_rows: Tensor, n: int, *, backend: str = "auto") -> Tensor:
    """(k, B) -> (n, B) systematic RS encode on the selected backend."""
    return rs.encode(data_rows, n, matmul=functools.partial(gf256_matmul, backend=backend))


def rs_decode(chunks: Tensor, chunk_ids, n: int, k: int, *, backend: str = "auto") -> Tensor:
    """Any k coded chunks -> (k, B) data rows on the selected backend."""
    return rs.decode(
        chunks, chunk_ids, n, k, matmul=functools.partial(gf256_matmul, backend=backend)
    )
