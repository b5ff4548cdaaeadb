"""Systematic (n, k) MDS Reed-Solomon codec over GF(2^8).

The port of ``repro/storage/rs.py``. Layout follows Tahoe/zfec semantics
(§V.A): a file is split into k equal chunks (rows); encoding produces n
chunks such that *any* k recover the file. Generator G = [I_k ; C] with C
a Cauchy matrix (every square submatrix of a Cauchy matrix is nonsingular
=> MDS for n <= 256).

The host half (matrices, inversion, payload split) is numpy, as in the
reference. The tensor half (:func:`encode`, :func:`decode`) runs where its
chunks live; its GF(256) matmul is swappable so ``repro_torch.kernels.ops``
can plug in the CUDA kernel.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch
from torch import Tensor

from .gf256 import _tables, gf_matmul_ref

MatmulFn = Callable[[Tensor, Tensor], Tensor]


@functools.lru_cache(maxsize=None)
def cauchy_parity_matrix(n: int, k: int) -> np.ndarray:
    """C[(n-k), k] with C[p, d] = 1 / (x_p ^ y_d), x = k..n-1, y = 0..k-1."""
    if not (0 < k <= n <= 256):
        raise ValueError(f"need 0 < k <= n <= 256, got ({n}, {k})")
    log, exp = _tables()

    def inv(a: int) -> int:
        return int(exp[(255 - int(log[a])) % 255]) if a else 0

    out = np.zeros((n - k, k), dtype=np.uint8)
    for p in range(n - k):
        for d in range(k):
            out[p, d] = inv((k + p) ^ d)  # x_p = k+p, y_d = d, disjoint sets
    return out


@functools.lru_cache(maxsize=None)
def generator_matrix(n: int, k: int) -> np.ndarray:
    """Systematic generator G (n, k): chunks = G @_GF data_rows."""
    g = np.zeros((n, k), dtype=np.uint8)
    g[:k] = np.eye(k, dtype=np.uint8)
    g[k:] = cauchy_parity_matrix(n, k)
    return g


def gf_invert_matrix(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(256) (host-side; k x k is tiny)."""
    log, exp = _tables()

    def mul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[int(log[a]) + int(log[b])])

    def inv(a):
        if a == 0:
            raise ZeroDivisionError("singular matrix over GF(256)")
        return int(exp[(255 - int(log[a])) % 255])

    m = np.array(m, dtype=np.uint8)
    k = m.shape[0]
    if m.shape != (k, k):
        raise ValueError(f"need a square matrix, got shape {m.shape}")
    aug = np.concatenate([m, np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        piv = next((r for r in range(col, k) if aug[r, col]), None)
        if piv is None:
            raise ZeroDivisionError("singular matrix over GF(256)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        pinv = inv(int(aug[col, col]))
        aug[col] = [mul(pinv, int(v)) for v in aug[col]]
        for r in range(k):
            if r != col and aug[r, col]:
                f = int(aug[r, col])
                aug[r] ^= np.array([mul(f, int(v)) for v in aug[col]], np.uint8)
    return aug[:, k:]


def pad_and_split(data: bytes | np.ndarray, k: int) -> np.ndarray:
    """Split a payload into k equal rows for encoding.

    Returns a (k, chunk_len) uint8 array with ``chunk_len = ceil(len / k)``;
    the tail of the last logical byte range is zero-padded. The original
    length is NOT stored anywhere in the coded representation — the caller
    tracks it and passes it back to :func:`decode_bytes` (the ``length``
    argument), which truncates the zero padding after reassembly. This is
    the Tahoe/zfec convention: chunk metadata lives in the storage index,
    not in the chunk bytes.
    """
    if isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        buf = np.asarray(data, np.uint8).ravel()
    chunk = -(-buf.size // k)  # ceil
    padded = np.zeros(k * chunk, dtype=np.uint8)
    padded[: buf.size] = buf
    return padded.reshape(k, chunk)


def encode(data_rows: Tensor, n: int, *, matmul: MatmulFn = gf_matmul_ref) -> Tensor:
    """(k, B) data rows -> (n, B) coded chunks (systematic)."""
    data_rows = torch.as_tensor(data_rows, dtype=torch.uint8)
    k = data_rows.shape[0]
    parity_mat = torch.as_tensor(cauchy_parity_matrix(n, k), device=data_rows.device)
    return torch.cat([data_rows, matmul(parity_mat, data_rows)], dim=0)


@functools.lru_cache(maxsize=4096)
def decode_matrix(n: int, k: int, ids: tuple[int, ...]) -> np.ndarray:
    """(k, k) decode matrix for erasure pattern ``ids``, LRU-cached.

    ``decode = inv(G[ids])``: the rows of the generator matrix picked by
    the surviving chunk indices, Gauss-Jordan-inverted once per distinct
    ``(n, k, ids)`` and reused — degraded-read storms hit the same few
    erasure patterns over and over (one per failed-node/file pair), so the
    inversion cost amortizes to zero.
    """
    if len(ids) != k or len(set(ids)) != k:
        raise ValueError(f"need exactly k={k} distinct chunks, got {list(ids)}")
    return gf_invert_matrix(generator_matrix(n, k)[list(ids)])


def decode(
    chunks: Tensor,
    chunk_ids: Sequence[int],
    n: int,
    k: int,
    *,
    matmul: MatmulFn = gf_matmul_ref,
) -> Tensor:
    """Recover (k, B) data rows from any k coded chunks.

    ``chunks`` is (k, B) holding the surviving chunks whose original row
    indices (0..n-1) are ``chunk_ids``. When all k data chunks arrived
    (every id < k — the common healthy-read case) the code is systematic,
    so the rows are returned by permutation with no inversion and no
    matmul at all; otherwise the (LRU-cached) inverse of the picked
    generator rows is applied.
    """
    ids = list(chunk_ids)
    if len(ids) != k or len(set(ids)) != k:
        raise ValueError(f"need exactly k={k} distinct chunks, got {ids}")
    chunks = torch.as_tensor(chunks, dtype=torch.uint8)
    if all(i < k for i in ids):
        # systematic fast path: G[ids] is a permutation of I_k, so
        # data[ids[j]] = chunks[j]; undo the permutation directly.
        order = torch.as_tensor(np.argsort(np.asarray(ids)), device=chunks.device)
        return chunks[order]
    dec = torch.as_tensor(decode_matrix(n, k, tuple(ids)), device=chunks.device)
    return matmul(dec, chunks)


def decode_bytes(
    chunks: Tensor, chunk_ids: Sequence[int], n: int, k: int, length: int, **kw
) -> bytes:
    """Decode + unpad: reassemble the payload and truncate to ``length``.

    ``length`` is the original payload size the caller recorded at
    :func:`pad_and_split` time (the codec itself never stores it); the
    zero padding appended there is cut off here.
    """
    rows = decode(chunks, chunk_ids, n, k, **kw).cpu().numpy()
    return rows.reshape(-1).tobytes()[:length]
