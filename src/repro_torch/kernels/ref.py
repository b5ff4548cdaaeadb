"""Plain PyTorch oracles for the GF(256) kernels (ground truth, bitwise)."""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.storage.gf256 import gf_matmul_ref, gf_mul_xtime


def gf256_matmul_ref(a: Tensor, b: Tensor) -> Tensor:
    """out[i, j] = XOR_k a[i, k] *GF b[k, j]; uint8 in/out, K-scan oracle."""
    return gf_matmul_ref(a, b)


def gf256_matmul_dense_ref(a: Tensor, b: Tensor) -> Tensor:
    """Fully-materialized (M, K, N) variant for small shapes — a second,
    structurally different oracle so the scan oracle is itself checked.
    torch has no xor-reduce, so the K axis is folded with ``^``."""
    a = torch.as_tensor(a, dtype=torch.uint8)
    b = torch.as_tensor(b, dtype=torch.uint8)
    prod = gf_mul_xtime(a[:, :, None], b[None, :, :])  # (M, K, N)
    out = torch.zeros_like(prod[:, 0])
    for kk in range(prod.shape[1]):
        out ^= prod[:, kk]
    return out
