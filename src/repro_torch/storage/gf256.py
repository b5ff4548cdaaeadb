"""GF(2^8) arithmetic (AES/zfec polynomial 0x11d) in PyTorch.

The port of ``repro/storage/gf256.py``. Three multiply strategies:

* :func:`gf_mul_table` — log/exp table lookups, the CPU/GPU (zfec) idiom.
  The CUDA GF(256) kernel (``kernels/csrc/gf256_matmul.cu``) uses it.
* :func:`gf_mul_xtime` — branchless 8-step carry-less multiply. The plain
  twins of the GF(256) kernels (``kernels/gf256_matmul.py``) use it, so the
  kernel's table arithmetic is held against an independent one.
* bit-matrix decomposition (:func:`gf_const_to_bitmatrix`) — each constant
  c becomes an 8x8 GF(2) matrix so a GF(256) matmul becomes one 0/1 matmul
  plus parity. See ``repro_torch.kernels.ops.gf256_matmul_bitplane``.

All functions act on uint8 tensors elementwise and run on the device their
inputs live on. torch's uint8 ``<<`` wraps modulo 256 as jnp's does
(``tests/test_torch_gf256.py`` checks it). Table lookups index with
``long``: a uint8 index tensor would be read as a boolean mask.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, generator g = 2 is primitive


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, exp) tables for GF(256) with generator 2."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]  # doubled so (log a + log b) needs no mod
    return log, exp


def _device_tables(device: torch.device) -> tuple[Tensor, Tensor]:
    log_np, exp_np = _tables()
    return (
        torch.as_tensor(log_np, dtype=torch.int64, device=device),
        torch.as_tensor(exp_np, device=device),
    )


def _u8(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.uint8)


def gf_mul_table(a: Tensor, b: Tensor) -> Tensor:
    """Table-based multiply (gather-heavy; reference semantics)."""
    a, b = _u8(a), _u8(b)
    log, exp = _device_tables(a.device)
    prod = exp[log[a.long()] + log[b.long()]]
    zero = (a == 0) | (b == 0)
    return torch.where(zero, torch.zeros_like(prod), prod)


def gf_mul_xtime(a: Tensor, b: Tensor) -> Tensor:
    """Branchless carry-less multiply: 8 rounds of conditional-xor + xtime.

    ``a`` and ``b`` broadcast against each other. Only the accumulator takes
    the broadcast shape; ``a`` and ``b`` keep their own through the rounds,
    so a column times a row costs one full-size tensor per op, not three.
    """
    a, b = _u8(a), _u8(b)
    acc = torch.zeros(
        torch.broadcast_shapes(a.shape, b.shape), dtype=torch.uint8, device=a.device
    )
    for _ in range(8):
        acc = torch.where((b & 1) != 0, acc ^ a, acc)
        a = torch.where((a & 0x80) != 0, (a << 1) ^ (POLY & 0xFF), a << 1)
        b = b >> 1
    return acc


gf_mul = gf_mul_xtime  # default


def gf_inv(a: Tensor) -> Tensor:
    """Multiplicative inverse via tables (a^(254)); inv(0) defined as 0."""
    a = _u8(a)
    log, exp = _device_tables(a.device)
    inv = exp[(255 - log[a.long()]) % 255]
    return torch.where(a == 0, torch.zeros_like(inv), inv)


def gf_matmul_ref(a: Tensor, b: Tensor) -> Tensor:
    """GF(256) matmul oracle: out[..., i, j] = XOR_k a[..., i, k] * b[..., k, j].

    A Python loop over K, one column-times-row :func:`gf_mul` per step, so
    memory stays at one (..., M, N) accumulator. Leading axes are batch
    axes (the reference's batched ``ref`` backend is a ``vmap`` of this).
    It is the ground truth for the CUDA kernels' plain twins and for the
    bit-plane path.
    """
    a, b = _u8(a), _u8(b)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} x {tuple(b.shape)}")
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
    out = torch.zeros(shape, dtype=torch.uint8, device=a.device)
    for kk in range(a.shape[-1]):
        out ^= gf_mul(a[..., :, kk, None], b[..., kk, None, :])
    return out


# --- bit-matrix (GF(2)) decomposition --------------------------------------


@functools.lru_cache(maxsize=None)
def _bit_basis() -> np.ndarray:
    """bit_basis[c] = 8x8 GF(2) matrix of 'multiply by c' in the bit basis.

    Column j of the matrix is the bit-pattern of c * 2^j; then
    bits(c*x) = M_c @ bits(x) mod 2 with bits little-endian.
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    log, exp = _tables()

    def mul(a, b):  # host-side scalar gf mul
        if a == 0 or b == 0:
            return 0
        return int(exp[int(log[a]) + int(log[b])])

    for c in range(256):
        for j in range(8):
            col = mul(c, 1 << j)
            for i in range(8):
                out[c, i, j] = (col >> i) & 1
    return out


def gf_const_to_bitmatrix(consts: Tensor) -> Tensor:
    """Map uint8 constants (shape S) -> GF(2) bit-matrices (S + (8, 8))."""
    consts = _u8(consts)
    basis = torch.as_tensor(_bit_basis(), device=consts.device)
    return basis[consts.long()]


def bytes_to_bits(x: Tensor) -> Tensor:
    """uint8 (..., n) -> bits (..., n, 8) little-endian, values in {0,1}."""
    x = _u8(x)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.int8)


def bits_to_bytes(bits: Tensor) -> Tensor:
    """bits (..., n, 8) -> uint8 (..., n)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    vals = (bits.to(torch.uint8) & 1) << shifts
    # bits are {0,1} in distinct positions, so sum == or
    return vals.to(torch.int32).sum(dim=-1).to(torch.uint8)
