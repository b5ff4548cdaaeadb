"""Kernel B4's float32 numerics and the bounds ``chip_smoke.py`` reports.

Kernel B4 computes float32 attention on TF32 tensor cores with CUTLASS's
3xTF32 split: x = big + small, big = rna_tf32(x), small = rna_tf32(x - big),
and each product as small*big + big*small + big*big, small terms first,
accumulated in float32. The card is not here, so these tests emulate that
arithmetic with numpy (rna_tf32 as integer operations on the float32 bits,
as the kernel does it) and hold it to float64 at SmolLM-135M's head width:
the scores within 2e-6, a whole causal attention within the 2e-5 the
kernel is held to against its plain twin, and a single TF32 pass outside
2e-5, which is why the split is there. They also pin the bounds
``chip_smoke.py`` computes for the main path's shapes.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

HD = 64  # SmolLM-135M's head width
SCALE = HD**-0.5


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rna_tf32(x):
    """cvt.rna.tf32.f32 on finite float32: round to nearest, ties away
    from zero, keeping 10 mantissa bits (the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = rna_tf32(x)
    return big, rna_tf32(np.float32(x) - big)


def mma_product(a, b, passes):
    """a (M, K) @ b (K, N) as the kernel's m16n8k8 steps: per 8-wide
    k-step, each pass's 8 products summed exactly (float64) and added to
    the float32 accumulator, in the order of ``passes``."""
    (ab, as_), (bb, bs) = split(a), split(b)
    ops = {"small_big": (as_, bb), "big_small": (ab, bs), "big_big": (ab, bb)}
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for name in passes:
            x, y = ops[name]
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


THREE = ("small_big", "big_small", "big_big")  # 3xTF32, small terms first
ONE = ("big_big",)  # one TF32 pass


def _qkv(seed, t):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, HD)).astype(np.float32) for _ in range(3))


def emulated_attention(q, k, v, passes):
    """Causal attention of one head as B4 computes it: S and P V through
    ``mma_product``, the softmax in float32, out = acc / l."""
    t = q.shape[0]
    s = mma_product(q, k.T.copy(), passes) * np.float32(SCALE)
    s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf).astype(np.float32)
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    acc = mma_product(p, v, passes)
    return acc / p.sum(axis=1, keepdims=True, dtype=np.float32)


def reference_attention(q, k, v):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    t = q.shape[0]
    s = np.where(np.tril(np.ones((t, t), bool)), (q @ k.T) * SCALE, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p @ v) / p.sum(axis=1, keepdims=True)


@pytest.mark.parametrize(
    "x,want",
    [
        (1.0, 1.0),
        (1.0 + 2.0**-11, 1.0 + 2.0**-10),  # a tie rounds away from zero
        (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
        (np.nextafter(np.float32(1.0 + 2.0**-11), np.float32(0)), 1.0),
        (2.0 - 2.0**-12, 2.0),  # the carry reaches the exponent
        (3.0e-39, 3.0e-39 - 3.0e-39 % 2.0**-136),  # subnormal: low 13 bits cleared
    ],
)
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    got = rna_tf32(np.float32(x))
    assert got == np.float32(want)
    assert got.view(np.uint32) & np.uint32(0x1FFF) == 0


def test_split_is_exact_and_small_is_tiny():
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 10
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    resid = x.astype(np.float64) - big - small
    assert np.all(np.abs(small) <= np.abs(x) * 2.0**-11)
    assert np.all(np.abs(resid) <= np.abs(x) * 2.0**-22)


def test_3xtf32_scores_within_2e6_of_float64():
    q, k, _ = _qkv(1, 256)
    want = (q.astype(np.float64) @ k.T.astype(np.float64)) * SCALE
    got = mma_product(q, k.T.copy(), THREE) * np.float32(SCALE)
    assert np.abs(got - want).max() <= 2e-6
    one = mma_product(q, k.T.copy(), ONE) * np.float32(SCALE)
    assert np.abs(one - want).max() > 2e-5  # one pass keeps about 3 digits


@pytest.mark.parametrize("seed", [2, 3])
def test_3xtf32_attention_within_the_kernels_tolerance(seed):
    q, k, v = _qkv(seed, 192)
    want = reference_attention(q, k, v)
    err3 = np.abs(emulated_attention(q, k, v, THREE) - want).max()
    err1 = np.abs(emulated_attention(q, k, v, ONE) - want).max()
    assert err3 <= 2e-5
    assert err1 > 2e-5  # a single TF32 pass misses atol 2e-5


def test_fcfs_bound_at_the_fleet_shape():
    cs = _chip_smoke()
    got = cs.bound(256, 100_000, 12)
    assert got["bound_by"] == "bytes"
    assert got["bound_gb"] == pytest.approx(1.740849152)
    assert got["bound_ms"] == pytest.approx(0.5197, abs=1e-4)
    assert cs.bound(1, 100_000, 12)["bound_ms"] == pytest.approx(got["bound_ms"] / 256, rel=1e-4)


def test_flash_bound_is_three_tf32_passes_at_smollm_prefill():
    cs = _chip_smoke()
    b, t, h, kh, hd = cs.FLASH_SHAPE
    q = torch.empty((b, t, h, hd), device="meta")
    k = torch.empty((b, t, kh, hd), device="meta")
    got = cs.flash_bound(q, k)
    assert got["bound_flop"] == 4 * hd * b * h * t * (t + 1) // 2 == 18_737_381_376
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(3 * 18_737_381_376 / 495e12 * 1e3)
    assert got["bound_ms"] == pytest.approx(0.114, abs=5e-4)
    assert got["bound_tf32_ms"] == pytest.approx(0.0379, abs=1e-4)
    assert got["bound_fp32_ms"] == pytest.approx(0.2797, abs=1e-4)
    assert got["bound_bytes_ms"] == pytest.approx(0.01479, abs=1e-5)
    assert got["bound_gb"] == pytest.approx(0.049545216)


def test_flash_bound_at_seamless_decoder_prefill():
    """hd = 64 at G = 1: SeamlessM4T-medium's decoder prefill in phase 14a."""
    cs = _chip_smoke()
    b, t, h, kh, hd = cs.ENCDEC_FLASH_SHAPE
    assert kh == h
    q = torch.empty((b, t, h, hd), device="meta")
    k = torch.empty((b, t, kh, hd), device="meta")
    got = cs.flash_bound(q, k)
    assert got["bound_flop"] == 4 * hd * b * h * t * (t + 1) // 2 == 16_655_450_112
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(0.101, abs=5e-4)
    assert got["bound_tf32_ms"] == pytest.approx(0.0336, abs=1e-4)
    assert got["bound_bytes_ms"] == pytest.approx(0.01972, abs=1e-5)


def test_flash_bound_at_mla_prefill_counts_both_widths():
    """q/k width 192 and v width 128 at DeepSeek-V3's MLA prefill in phase
    15: 2 x (192 + 128) FLOP a visible pair, and q, k, v and the output
    each at its own width."""
    cs = _chip_smoke()
    b, t, h, kh, hd, vd = cs.MLA_FLASH_SHAPE
    q = torch.empty((b, t, h, hd), device="meta")
    k = torch.empty((b, t, kh, hd), device="meta")
    v = torch.empty((b, t, kh, vd), device="meta")
    got = cs.flash_bound(q, k, v)
    pairs = b * h * t * (t + 1) // 2
    assert pairs == 520_482_816
    assert got["bound_flop"] == 2 * (hd + vd) * pairs == 333_109_002_240
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(2.019, abs=5e-4)
    assert got["bound_tf32_ms"] == pytest.approx(0.673, abs=5e-4)
    assert got["bound_gb"] == pytest.approx(2 * 4 * b * t * h * (hd + vd) / 1e9) == pytest.approx(
        1.321, abs=5e-4)
    assert got["bound_bytes_ms"] == pytest.approx(0.3944, abs=1e-4)
    # v of k's shape is the default, as for every other instance
    assert cs.flash_bound(q, k) == cs.flash_bound(q, k, k)


@pytest.mark.parametrize("shape", [(1, 6, 6, 349_525_500), (500, 6, 6, 699_051)])
def test_gf_bound_at_the_codec_path_shapes(shape):
    """B2's (12, 6) encode and B3's (12, 6) decode move the same bytes:
    bound by them, with the design's work (one lookup a column and k, 29
    integer operations a column) under them at the INT32 peak."""
    cs = _chip_smoke()
    got = cs.gf_bound(*shape)
    assert got["bound_by"] == "bytes"
    assert got["bound_gb"] == pytest.approx(4.194, abs=5e-4)
    assert got["bound_ms"] == pytest.approx(1.2520, abs=5e-5)
    assert got["gf_lookups"] == 6 * 349_525_500 == 6 * 500 * 699_051
    assert got["gf_int_ops"] == 29 * 349_525_500
    assert got["gf_int_ops"] / cs.INT32_OPS_PER_S * 1e3 == pytest.approx(0.6060, abs=5e-4)


def test_gf_bound_counts_passes_of_8_rows_and_7_k():
    """M = 13 runs 2 row passes (8 and 5 rows), K = 16 three k passes
    (7, 7 and 2) each: lookups count every pass."""
    got = _chip_smoke().gf_bound(1, 13, 16, 100)
    assert got["gf_lookups"] == 100 * 16 * 2
    per_col = sum(3 * kc + (4 if rows > 4 else 2) + (kc + rows) / 2 + 1
                  for rows in (8, 5) for kc in (7, 7, 2))
    assert got["gf_int_ops"] == pytest.approx(100 * per_col)


def test_flash_bound_counts_the_window_at_recurrentgemma_forward():
    """RecurrentGemma's local attention in phase 16b's forward, (2, 4096, 10,
    1, 256) with window 2048: row i sees min(i + 1, 2048) keys, 1.259e8
    pairs where the causal mask alone leaves 1.678e8; 2 x (256 + 256) FLOP
    a pair."""
    cs = _chip_smoke()
    b, t, h, kh, hd, window = cs.RG_FLASH_SHAPE
    assert (b, t, h, kh, hd, window) == (2, 4096, 10, 1, 256, 2048)
    q = torch.empty((b, t, h, hd), device="meta")
    k = torch.empty((b, t, kh, hd), device="meta")
    causal = cs.flash_bound(q, k)
    got = cs.flash_bound(q, k, window=window)
    assert causal["bound_pairs"] == b * h * t * (t + 1) // 2 == 167_813_120
    per_row = window * (window + 1) // 2 + (t - window) * window
    assert got["bound_pairs"] == b * h * per_row == 125_849_600
    assert got["bound_flop"] == 1024 * 125_849_600 == 128_869_990_400
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(0.781, abs=5e-4)
    assert got["bound_tf32_ms"] == pytest.approx(0.260, abs=5e-4)
    assert got["bound_gb"] == pytest.approx(0.184549376)
    assert got["bound_bytes_ms"] == pytest.approx(0.0551, abs=1e-4)
    # a window at least T long, or None, is the causal count
    assert cs.flash_bound(q, k, window=t) == causal
    # a window of 1 sees the diagonal alone
    assert cs.flash_bound(q, k, window=1)["bound_pairs"] == b * h * t
