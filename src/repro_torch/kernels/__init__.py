"""Hand-written Hopper kernels, each beside its plain PyTorch twin: the
FCFS fleet-queue scan (B1), the GF(256) erasure-coding product (B2, B3)
and causal / sliding-window GQA flash attention (B4, in the
``flash_attention`` module, which is not re-exported here)."""
from .fcfs_queue import fcfs_scan, fcfs_scan_cuda, fcfs_scan_plain
from .gf256_matmul import (
    gf256_matmul_batched_cuda,
    gf256_matmul_batched_plain,
    gf256_matmul_cuda,
    gf256_matmul_plain,
)
from .ops import (
    gf256_matmul,
    gf256_matmul_batch,
    gf256_matmul_batch_bitplane,
    gf256_matmul_bitplane,
    rs_decode,
    rs_encode,
)
from .ref import gf256_matmul_dense_ref, gf256_matmul_ref
