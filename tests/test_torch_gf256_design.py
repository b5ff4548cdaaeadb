"""The arithmetic of kernels B2 and B3 (``csrc/gf256_matmul.cu``), on the CPU.

The kernel cannot run here, so these tests emulate what it computes, step
by step and lane by lane, with numpy, and hold the result bitwise to the
reference's ``gf256_matmul_ref`` oracle and to its Pallas kernel in
interpret mode. The emulation follows the source:

* a pass of at most 8 rows and 7 values of k; its tables built as the
  block builds them (one packed 8-round xtime multiply per entry, written
  to the copy of bank pair e % 16, then copied to the other 15), and read
  at byte offset ``((x >> (8q - 7)) & 0x7f80) | lane_off`` of the lane's copy;
* the granule partition of the persistent grid: blocks, segments (one
  batch element each), one range a warp (16 warps a block for up to 4
  values of k, 12 above), steps of 32 lanes;
* B read only as aligned 16-byte chunks, each lane's window joined from its
  chunk and the next lane's (lane 31: lane 0's of the next step) by a
  funnel shift;
* the packed XOR over k and the 4 x 4 byte transpose by ``__byte_perm``;
* C stored as aligned 16-byte chunks, joined from the previous lane's
  bytes (lane 0: lane 31's of the previous step) and the lane's own, with
  the chunks at a range's ends stored partially; later k passes XOR in.

Memory is one flat byte array with B and C placed at chosen offsets from
a 16-byte boundary, so the windows see the rows' real misalignment. The
emulation also asserts the kernel's memory discipline: every chunk it loads
overlaps B, every byte of C is written exactly once a pass, and nothing
outside C is written. ``packed_product_tables`` (the port's torch statement
of the tables) is held to the reference's multiply.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.storage.gf256 as ref_gf
from repro.kernels import gf256_matmul_pallas, gf256_matmul_pallas_batched
from repro.kernels import gf256_matmul_ref as ref_matmul
from repro_torch.kernels.gf256_matmul import packed_product_tables
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GRAN, ROWS, KC, COPIES = 16, 8, 7, 16  # the source's constants
TABLE_BYTES = 256 * COPIES * 8
LOW7, LSB = np.uint64(0x7F7F7F7F7F7F7F7F), np.uint64(0x0101010101010101)
U32 = np.uint64(0xFFFFFFFF)


def warps_for(kc):
    """The source's ``threads_for(kc) / 32``."""
    return 16 if kc <= 4 else 12


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def xtime8(v):
    return ((v & LOW7) << np.uint64(1)) ^ (((v >> np.uint64(7)) & LSB) * np.uint64(0x1D))


def mul8(col, e):
    """The kernel's ``mul8``: 8 packed bytes times e, 8 rounds of xtime."""
    v = np.zeros_like(col)
    for p in range(8):
        v = np.where((e >> p) & 1, v ^ col, v)
        col = xtime8(col)
    return v


def build_tables(a_pass):
    """Shared memory after ``build_tables``: (kc * 256 * 16,) uint64, entry
    e of table k in copy c at index (k * 256 + e) * 16 + c."""
    rows, kc = a_pass.shape
    cols = np.zeros(kc, np.uint64)
    for i in range(rows):
        cols |= a_pass[i].astype(np.uint64) << np.uint64(8 * i)
    idx = np.arange(kc * 256)
    e = idx & 255
    smem = np.zeros(kc * 256 * COPIES, np.uint64)
    smem[idx * COPIES + (e & 15)] = mul8(cols[idx >> 8], e)
    idx = np.arange(kc * 256 * COPIES)
    ke = idx >> 4
    smem[idx] = smem[ke * COPIES + (ke & 15)]
    return smem


def funnel_r(lo, hi, f):
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo) >> np.uint64(f)) & U32


def window(lo, hi, sh):
    """Bytes sh .. sh + 15 of the 32 bytes (lo, hi); lo, hi (lanes, 4) words."""
    x = np.concatenate([lo, hi], axis=1).astype(np.uint64)
    d, f = sh >> 2, 8 * (sh & 3)
    return np.stack([funnel_r(x[:, d + i], x[:, d + i + 1], f) for i in range(4)],
                    axis=1).astype(np.uint32)


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` for selectors without the sign-replicate bit."""
    src = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(src)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def transpose4(a0, a1, a2, a3):
    t0, t1 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
    t2, t3 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
    return (byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632))


class Memory:
    """One flat byte array holding B at ``b_addr`` and C at ``c_addr``."""

    def __init__(self, b, c_shape, b_mis, c_mis):
        self.b_addr = 64 + b_mis
        self.b_end = self.b_addr + b.size
        self.c_addr = 64 * (-(-(self.b_end + 64) // 64)) + c_mis
        self.c_end = self.c_addr + int(np.prod(c_shape))
        self.mem = np.random.default_rng(7).integers(0, 256, self.c_end + 64, dtype=np.uint8)
        self.mem[self.b_addr:self.b_end] = b.reshape(-1)
        self.writes = np.zeros(self.c_end - self.c_addr, np.int64)
        self.c_shape = c_shape

    def load_chunks(self, addr):
        """Aligned 16-byte chunks at ``addr``, each holding a byte of B."""
        assert (addr % 16 == 0).all() and (addr < self.b_end).all()
        assert (addr + 16 > self.b_addr).all()
        return self.mem[addr[:, None] + np.arange(16)].view("<u4")

    def store(self, dst, out, lo, hi, accumulate):
        assert dst % 16 == 0 and self.c_addr <= dst + lo and dst + hi <= self.c_end
        if accumulate:
            out = out ^ self.mem[dst:dst + 16]
        self.mem[dst + lo:dst + hi] = out[lo:hi]
        self.writes[dst + lo - self.c_addr:dst + hi - self.c_addr] += 1

    def c(self):
        return self.mem[self.c_addr:self.c_end].reshape(self.c_shape).copy()


def run_range(mem, smem, n, kc, rows, brow, crow, w0, w1, accumulate):
    """One warp's range [w0, w1) of granules, as ``run_range`` walks it."""
    lane = np.arange(32)
    lane_off = (lane & 15) * 8
    sh = [(brow + kk * n) & 15 for kk in range(kc)]

    def load_step(g):
        out = np.zeros((kc, 32, 4), np.uint32)
        for kk in range(kc):
            chunk = (brow + kk * n + GRAN * g) & ~15
            ok = (g <= w1) & (chunk < mem.b_end)
            out[kk, ok] = mem.load_chunks(chunk[ok])
        return out

    cur = load_step(w0 + lane)
    carry = np.random.default_rng(w0).integers(0, 2**32, (ROWS, 4), dtype=np.uint32)
    gs = w0
    while gs <= w1:
        g = gs + lane
        nxt = load_step(g + 32)
        acc = np.zeros((32, GRAN), np.uint64)
        for kk in range(kc):
            src = np.where((lane == 0)[:, None], nxt[kk], cur[kk])
            v = window(cur[kk], src[(lane + 1) % 32], sh[kk])
            for q in range(GRAN):
                x = v[:, q >> 2].astype(np.int64)
                s = 8 * (q & 3) - 7
                off = ((x << 7 if s < 0 else x >> s) & 0x7F80) | lane_off
                acc[:, q] ^= smem[(kk * TABLE_BYTES + off) // 8]
        lo_w, hi_w = (acc & U32).astype(np.uint32), (acc >> np.uint64(32)).astype(np.uint32)
        row = np.zeros((ROWS, 32, 4), np.uint32)
        for j in range(4):
            row[0:4, :, j] = transpose4(*(lo_w[:, 4 * j + c] for c in range(4)))
            if rows > 4:
                row[4:8, :, j] = transpose4(*(hi_w[:, 4 * j + c] for c in range(4)))
        own_len = np.where(g < w1, np.minimum(GRAN, n - GRAN * g), 0)
        prev_ok = (g > w0) & (g <= w1)
        prev_len = np.where(prev_ok, np.minimum(GRAN, n - GRAN * (g - 1)), 0)
        for i in range(rows):
            prev = row[i][(lane + 31) % 32]
            prev[0] = carry[i]
            ci = crow + i * n
            s = ci & 15
            chunk = window(prev, row[i], 16 - s) if s else row[i]
            lo = np.where(prev_ok, 0, s)
            hi = np.where(g > w1, 0, np.where(own_len > 0, s + np.minimum(own_len, 16 - s),
                                              np.maximum(0, s + prev_len - 16)))
            for t in np.nonzero(lo < hi)[0]:
                mem.store(ci + GRAN * int(g[t]) - s, chunk[t].view(np.uint8), int(lo[t]),
                          int(hi[t]), accumulate)
        carry = row[:, 31].copy()
        cur = nxt
        gs += 32


def emulate(a, b, *, b_mis=0, c_mis=0, blocks=3, warps=None):
    """C = A @GF B, (batch, m, k) x (batch, k, n), as the kernel's passes
    compute it. ``b_mis`` and ``c_mis`` place B and C that many bytes past
    a 16-byte boundary; ``warps`` overrides the source's warps a block.
    Returns C and the count of writes of each C byte."""
    batch, m, k = a.shape
    n = b.shape[2]
    mem = Memory(b, (batch, m, n), b_mis, c_mis)
    per_elem = -(-n // GRAN)
    total = batch * per_elem
    for r0 in range(0, m, ROWS):
        rows = min(ROWS, m - r0)
        for k0 in range(0, k, KC):
            kc = min(KC, k - k0)
            n_warps = warps or warps_for(kc)
            for blk in range(blocks):
                g, g_end = total * blk // blocks, total * (blk + 1) // blocks
                while g < g_end:
                    bb = g // per_elem
                    first = bb * per_elem
                    seg_end = min(g_end, first + per_elem)
                    smem = build_tables(a[bb, r0:r0 + rows, k0:k0 + kc])
                    h0, h = g - first, seg_end - g
                    for w in range(n_warps):
                        w0, w1 = h0 + h * w // n_warps, h0 + h * (w + 1) // n_warps
                        if w0 < w1:
                            run_range(mem, smem, n, kc, rows,
                                      mem.b_addr + (bb * k + k0) * n,
                                      mem.c_addr + (bb * m + r0) * n, w0, w1, k0 > 0)
                    g = seg_end
    return mem.c(), mem.writes.reshape(batch, m, n)


def reference(a, b):
    return np.stack([np.asarray(ref_matmul(jnp.asarray(x), jnp.asarray(y)))
                     for x, y in zip(a, b)])


def check(a, b, **kw):
    got, writes = emulate(a, b, **kw)
    np.testing.assert_array_equal(got, reference(a, b))
    passes = -(-a.shape[2] // KC)
    assert (writes == passes).all(), "a C byte was written other than once a pass"
    return got


# ------------------------------------------------------------- the tables


@pytest.mark.parametrize("m,k", [(1, 1), (4, 6), (6, 6), (8, 7)])
def test_packed_product_tables_hold_every_product(m, k):
    a = _rand(m * 10 + k, m, k)
    got = packed_product_tables(torch.from_numpy(a)).numpy().view(np.uint64)
    e = jnp.arange(256, dtype=jnp.uint8)
    want = np.asarray(ref_gf.gf_mul_xtime(jnp.asarray(a)[:, :, None], e))  # (m, k, 256)
    for i in range(m):
        np.testing.assert_array_equal(
            ((got >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8), want[i])
    assert m == 8 or not (got >> np.uint64(8 * m)).any()


def test_kernel_tables_equal_packed_product_tables_in_every_copy():
    a = _rand(3, 8, 7)
    smem = build_tables(a).reshape(7, 256, COPIES)
    want = packed_product_tables(torch.from_numpy(a)).numpy().view(np.uint64)
    for c in range(COPIES):
        np.testing.assert_array_equal(smem[:, :, c], want)


def test_lane_copies_are_conflict_free():
    """The 16 lanes of a half-warp read 16 different bank pairs (4-byte
    banks, 8-byte entries) whatever the bytes they look up."""
    rng = np.random.default_rng(0)
    for _ in range(100):
        e = rng.integers(0, 256, 16)
        off = (e << 7) | (np.arange(16) * 8)
        assert len(set((off // 8) % 16)) == 16


def test_packed_xtime_is_bytewise():
    v = np.random.default_rng(1).integers(0, 2**63, 64, dtype=np.uint64)
    got = xtime8(v).view(np.uint8)
    want = np.asarray(ref_gf.gf_mul_xtime(jnp.asarray(v.view(np.uint8)), jnp.uint8(2)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- repack and windows alone


def test_transpose4_turns_columns_into_rows():
    cols = _rand(2, 4, 4)  # cols[c, r]: row r of column c
    words = cols.view("<u4").reshape(4)
    rows = transpose4(*(words[c:c + 1] for c in range(4)))
    got = np.stack([r.view(np.uint8) for r in rows])  # got[r, c]
    np.testing.assert_array_equal(got, cols.T)


@pytest.mark.parametrize("sh", range(16))
def test_window_takes_bytes_sh_to_sh_plus_16(sh):
    x = _rand(sh, 3, 32)
    words = x.view("<u4")
    got = window(words[:, :4], words[:, 4:], sh).view(np.uint8)
    np.testing.assert_array_equal(got, x[:, sh:sh + 16])


# ------------------------------------------------ the whole kernel, emulated


@pytest.mark.parametrize("m", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("k", [4, 6, 7])
def test_codec_shapes_at_odd_width_and_offsets(m, k):
    """Every (M, K) the codec calls: encode (n - k, k), decode (k, k)."""
    n = 1001
    a, b = _rand(m * 8 + k, 1, m, k), _rand(k, 1, k, n)
    check(a, b, b_mis=m, c_mis=k + 3)


@pytest.mark.parametrize("b_mis,c_mis", [(0, 0), (1, 15), (8, 4), (13, 7)])
def test_batched_decode_shape_matches_pallas(b_mis, c_mis):
    """B3's batch of degraded reads, against the Pallas kernel."""
    a, b = _rand(11, 5, 6, 6), _rand(12, 5, 6, 699)
    got = check(a, b, b_mis=b_mis, c_mis=c_mis, blocks=4)
    want = gf256_matmul_pallas_batched(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_encode_shape_matches_pallas_with_the_kernels_partition():
    """B2 at the (12, 6) encode's (M, K), N = 12 mod 16 as on the path, with
    the source's 12 warps a block and ranges of several steps each (the
    carry)."""
    a, b = _rand(13, 1, 6, 6), _rand(14, 1, 6, GRAN * 32 * warps_for(6) * 2 * 3 + 12)
    got = check(a, b, b_mis=0, c_mis=0, blocks=2)
    want = gf256_matmul_pallas(jnp.asarray(a[0]), jnp.asarray(b[0]), interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 33])
def test_narrow_widths(n):
    a, b = _rand(n, 3, 6, 6), _rand(n + 1, 3, 6, n)
    check(a, b, b_mis=n % 16, c_mis=(3 * n) % 16, blocks=2)


def test_more_rows_than_a_pass_and_more_k_than_a_pass():
    """M = 13 (two row passes) and K = 16 (three k passes, the later ones
    XOR into C), against the Pallas kernel."""
    a, b = _rand(15, 1, 13, 16), _rand(16, 1, 16, 301)
    got = check(a, b, b_mis=5, c_mis=9)
    want = gf256_matmul_pallas(jnp.asarray(a[0]), jnp.asarray(b[0]), interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want))


def test_zero_rows_and_zero_bytes():
    a, b = _rand(17, 2, 7, 7), _rand(18, 2, 7, 517)
    a[0, 2] = 0  # a zero row of A
    a[1, :, 3] = 0  # a zero column of A
    b[0, 4] = 0  # a zero row of B
    b[1, :, ::3] = 0  # zero bytes in B
    got = check(a, b, b_mis=3, c_mis=11)
    assert not got[0, 2].any()


def test_many_batch_elements_per_block():
    """Blocks whose granule runs cross many batch elements (a segment each,
    tables rebuilt each time), starting and ending inside elements."""
    a, b = _rand(19, 40, 6, 6), _rand(20, 40, 6, 37)
    check(a, b, b_mis=9, c_mis=2, blocks=7, warps=4)
