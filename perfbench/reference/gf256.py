"""The stated code: systematic Reed-Solomon over GF(2^8), polynomial 0x11d.

Generator G = [I_k ; C] with the Cauchy parity C[p, d] = 1 / ((k + p) xor d)
(p < n - k, d < k), the matrix HDFS's RS codec and ISA-L's
`gf_gen_cauchy1_matrix` use. Tables and small matrices are NumPy (log and
antilog tables); products over payload rows are plain PyTorch gathers from
the 256 x 256 product table, on whatever device the rows live on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor

POLY = 0x11D


@functools.lru_cache(maxsize=None)
def tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, antilog) for generator 2; antilog doubled to skip a modulo."""
    antilog = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        antilog[i] = antilog[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return log, antilog


@functools.lru_cache(maxsize=None)
def product_table() -> np.ndarray:
    """(256, 256) uint8: entry [a, b] = a * b in GF(2^8)."""
    log, antilog = tables()
    a = np.arange(256)
    out = antilog[log[a][:, None] + log[a][None, :]].astype(np.uint8)
    out[0, :] = 0
    out[:, 0] = 0
    return out


def inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    log, antilog = tables()
    return int(antilog[(255 - log[a]) % 255])


def cauchy(n: int, k: int) -> np.ndarray:
    return np.array([[inverse((k + p) ^ d) for d in range(k)] for p in range(n - k)],
                    dtype=np.uint8).reshape(n - k, k)


def generator(n: int, k: int) -> np.ndarray:
    return np.concatenate([np.eye(k, dtype=np.uint8), cauchy(n, k)])


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Small matrices: (M, K) x (K, N) over GF(2^8)."""
    mul = product_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for kk in range(a.shape[1]):
        out ^= mul[a[:, kk][:, None], b[kk][None, :]]
    return out


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion of a small square matrix over GF(2^8)."""
    mul = product_table()
    k = m.shape[0]
    aug = np.concatenate([np.array(m, dtype=np.uint8), np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        pivots = np.nonzero(aug[col:, col])[0]
        if pivots.size == 0:
            raise ZeroDivisionError("singular matrix over GF(2^8)")
        piv = col + int(pivots[0])
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = mul[inverse(int(aug[col, col])), aug[col]]
        for r in range(k):
            if r != col and aug[r, col]:
                aug[r] ^= mul[int(aug[r, col]), aug[col]]
    return aug[:, k:]


def rows_mul(a: np.ndarray, rows: Tensor) -> Tensor:
    """(M, K) small matrix times (K, L) uint8 payload rows -> (M, L), as a
    XOR of table gathers on the rows' device."""
    table = torch.as_tensor(product_table(), device=rows.device)
    out = torch.zeros((a.shape[0], rows.shape[1]), dtype=torch.uint8, device=rows.device)
    for kk in range(a.shape[1]):
        idx = rows[kk].long()
        for i in range(a.shape[0]):
            if a[i, kk]:
                out[i] ^= table[int(a[i, kk])][idx]
    return out


def encode(data: Tensor, n: int) -> Tensor:
    """(k, L) data rows -> (n, L) coded rows: the data, then the parity."""
    k = data.shape[0]
    return torch.cat([data, rows_mul(cauchy(n, k), data)])


def decode(chunks: Tensor, ids, n: int, k: int) -> Tensor:
    """(k, L) surviving rows whose code rows are ``ids`` -> (k, L) data rows."""
    return rows_mul(invert(generator(n, k)[list(ids)]), chunks)


def xor_parity(data: Tensor, n: int) -> Tensor:
    """The control's code: every parity row the XOR of the data rows, a code
    that survives one lost row where the stated one survives n - k."""
    parity = data[0].clone()
    for row in data[1:]:
        parity ^= row
    return torch.cat([data, parity.expand(n - data.shape[0], -1)])
