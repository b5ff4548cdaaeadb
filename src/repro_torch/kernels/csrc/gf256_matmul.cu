// GF(2^8) matrix product for Hopper (sm_90a): C = A @GF B, unbatched and
// batched. The Reed-Solomon encode and degraded-read decode of the data
// plane (repro_torch/storage/codec.py) run on it.
//
// Replaces the Pallas TPU kernels `gf256_matmul_pallas` (unbatched, body
// `_kernel` -> `_block_matmul` -> `_gf_mul_tile`) and
// `gf256_matmul_pallas_batched` (body `_kernel_batched`) in
// src/repro/kernels/gf256_matmul.py. Both compute
//
//     C[b, i, j] = XOR_k A[b, i, k] * B[b, k, j]     over GF(2^8), POLY 0x11d
//
// on uint8. The TPU kernel multiplies with 8 rounds of xtime because the
// TPU's vector unit has no gathers; an SM has fast shared memory, so this
// kernel multiplies by table lookup. GF(256) arithmetic is exact, so both
// give the same bytes, and the kernel is held bitwise against its xtime
// plain twin (kernels/gf256_matmul.py).
//
// Design.
// * Row-packed product tables. A pass takes up to ROWS = 8 output rows and
//   up to KC = 7 values of k. For each k of the pass the block builds
//   T_k[e] = (A[r0,k]*e, ..., A[r0+7,k]*e), one byte a row packed into an
//   8-byte word, for all 256 bytes e. A column then costs one 8-byte
//   lookup and two xors per k: C's column j is XOR_k T_k[B[k, j]], its
//   byte i is row i. Every codec call has M <= 8 and K <= 7, so one pass.
// * Bank conflicts. The indices are data bytes, random. Each table is kept
//   in 16 copies, entry e of copy c at byte e*128 + c*8, and lane l reads
//   copy l % 16: the 16 lanes of a half-warp (one wavefront of 8-byte
//   loads) always hit 16 different bank pairs. 32 KB a k, 224 KB for 7.
// * Tables built once per block and batch element, in parallel: one
//   packed multiply (8 rounds of xtime on 8 bytes at once) per entry,
//   then copied to the other 15 copies, a half-warp writing one entry's 16.
// * A persistent grid: one block per SM, of 16 warps for kc <= 4 and 12
//   above (threads_for). The batch's columns are cut into 16-column
//   granules; each block takes a contiguous run of granules, and each
//   batch element within it (a segment) is split into contiguous ranges,
//   one a warp. A warp walks its range 32 granules (512 columns) a step,
//   lane l on granule l.
// * Bytes in flight. A lane loads the 16-byte-aligned chunk of each B row
//   that holds its granule's first column, one step ahead of use: kc rows
//   x 512 B a warp, 32 KB an SM at K = 4, 36 KB at 6, 42 KB at 7. The
//   loads ask L2 for the whole 256-byte block (B is read once, in order).
//   Codec rows have odd widths, so a granule's 16 columns straddle two
//   aligned chunks: the second is the next lane's (a shuffle; lane 31
//   takes lane 0's of the next step), and a funnel shift by the row's
//   offset, the same for the whole segment, joins them. Only aligned
//   16-byte loads touch memory; an aligned chunk that holds a byte of B
//   stays inside its allocation.
// * Row repack. Four columns' packed words become four rows' words with
//   8 byte permutes (a 4 x 4 byte transpose), twice for 8 rows.
// * Aligned stores whatever the row's alignment. Lane l stores the aligned
//   16-byte chunk of C's row that holds its granule's first column: the
//   previous lane's last bytes and its own first (a shuffle; lane 0 takes
//   lane 31's of the previous step, kept in shared memory), joined by a
//   funnel shift. Only the chunks at the ends of a warp's range are
//   partial, and those are stored byte by byte, so that two ranges that
//   share a chunk never write each other's bytes.
// * M > 8 and K > 7 run as passes of the same kernel, one launch each: row
//   passes of 8, and k passes of 7 whose later passes XOR into C.
// * Offsets are size_t: the (12, 6) encode's B operand is 2.1e9 bytes.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). Bytes: each input read once and each output written
// once, B*(M*K + K*N + M*N); for the §V.B (12, 6) encode group that is
// 4.194 GB, 1.252 ms at 3.35 TB/s. The design's own work for that group
// (N = 3.495e8 columns): 6 lookups a column, 2.1e9 in all, 0.50 ms at the
// 128 bytes a clock an SM of conflict-free 8-byte loads; about 29 integer
// operations a column (per k: a shift and a mask for the index, an xor;
// per column: the repack and the two funnel shifts), 1.0e10 in all, 0.61
// ms at 64 a clock an SM (1.98 GHz boost). Both sit under the bytes, so
// the bytes bind. chip_smoke.py measures the lookup rate (phase 1) and
// prints this work at the measured rates beside the kernel's time.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Threads a block for a pass of kc values of k: 16 warps keep more bytes
// in flight, but above kc = 4 their 128 registers spill, so 12 warps (up
// to 168 registers) take kc = 5..7. One block an SM either way.
__host__ __device__ constexpr int threads_for(int kc) { return kc <= 4 ? 512 : 384; }
constexpr int GRAN = 16;                 // columns a lane takes a step: one 16-byte chunk
constexpr long long LGRAN = GRAN;
constexpr int ROWS = 8;                  // output rows a pass: one 8-byte table entry
constexpr int KC = 7;                    // values of k a pass
constexpr int COPIES = 16;               // copies of each table, one a bank pair
constexpr int TABLE_BYTES = 256 * COPIES * 8;
constexpr uint64_t LOW7 = 0x7f7f7f7f7f7f7f7full;
constexpr uint64_t LSB = 0x0101010101010101ull;
constexpr uint64_t POLY_LOW = 0x1d;      // POLY 0x11d less x^8

constexpr size_t smem_bytes(int kc) {
  return size_t(kc) * TABLE_BYTES + threads_for(kc) / 32 * ROWS * 16;
}

struct Params {
  const uint8_t* a;  // (batch, m, k)
  const uint8_t* b;  // (batch, k, n)
  uint8_t* c;        // (batch, m, n)
  long long batch, n;
  int m, k;          // full extents, for the strides
  int r0, rows;      // this pass: output rows r0 .. r0 + rows - 1, rows <= ROWS
  int k0;            // this pass: k0 .. k0 + kc - 1
  int accumulate;    // XOR into C: every k pass after the first
};

// Byte-wise multiply of 8 packed bytes by x (POLY 0x11d).
__device__ __forceinline__ uint64_t xtime8(uint64_t v) {
  return ((v & LOW7) << 1) ^ (((v >> 7) & LSB) * POLY_LOW);
}

// Byte-wise product of 8 packed bytes with e.
__device__ __forceinline__ uint64_t mul8(uint64_t col, unsigned e) {
  uint64_t v = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if ((e >> p) & 1) v ^= col;
    col = xtime8(col);
  }
  return v;
}

// Bytes sh .. sh + 15 of the 32 bytes lo, hi (sh in 0..15, the same for
// the whole warp).
__device__ __forceinline__ uint4 window(const uint4 lo, const uint4 hi, unsigned sh) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const unsigned f = 8 * (sh & 3);
#define GF_WINDOW(d)                                                             \
  make_uint4(__funnelshift_r(x[d], x[d + 1], f), __funnelshift_r(x[d + 1], x[d + 2], f), \
             __funnelshift_r(x[d + 2], x[d + 3], f), __funnelshift_r(x[d + 3], x[d + 4], f))
  switch (sh >> 2) {
    case 0: return GF_WINDOW(0);
    case 1: return GF_WINDOW(1);
    case 2: return GF_WINDOW(2);
    default: return GF_WINDOW(3);
  }
#undef GF_WINDOW
}

// A 16-byte load through the read-only path that asks L2 to fetch the
// whole 256-byte block around it: B is streamed once, in order.
__device__ __forceinline__ uint4 load_l2_256(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 shfl4(const uint4 v, int src) {
  return make_uint4(__shfl_sync(~0u, v.x, src), __shfl_sync(~0u, v.y, src),
                    __shfl_sync(~0u, v.z, src), __shfl_sync(~0u, v.w, src));
}

// Columns 0..3 (bytes: rows 0..3 of each) -> rows 0..3 (bytes: columns).
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                           uint32_t& r3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  r0 = __byte_perm(t0, t2, 0x5410);
  r1 = __byte_perm(t0, t2, 0x7632);
  r2 = __byte_perm(t1, t3, 0x5410);
  r3 = __byte_perm(t1, t3, 0x7632);
}

// Bytes lo .. hi - 1 of v to dst[lo .. hi - 1].
__device__ __noinline__ void store_part(uint8_t* dst, const uint4 v, int lo, int hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (q >= lo && q < hi) dst[q] = uint8_t(w[q >> 2] >> (8 * (q & 3)));
  }
}

// The pass's KCP tables for batch element bb, in all 16 copies.
template <int KCP>
__device__ void build_tables(unsigned char* smem, const Params& p, long long bb) {
  uint2* tab = reinterpret_cast<uint2*>(smem);
  const uint8_t* a = p.a + (size_t(bb) * p.m + p.r0) * p.k + p.k0;
  // each entry once, into the copy of bank pair e % 16 (conflict-free)
  for (int idx = threadIdx.x; idx < KCP * 256; idx += threads_for(KCP)) {
    const int kk = idx >> 8, e = idx & 255;
    uint64_t col = 0;
    for (int i = 0; i < p.rows; ++i) col |= uint64_t(a[size_t(i) * p.k + kk]) << (8 * i);
    const uint64_t v = mul8(col, e);
    tab[idx * COPIES + (e & 15)] = make_uint2(uint32_t(v), uint32_t(v >> 32));
  }
  __syncthreads();
  // then into the other 15: a half-warp reads one entry (a broadcast) and
  // writes its 16 copies; the slot read is rewritten with its own value
  for (int idx = threadIdx.x; idx < KCP * 256 * COPIES; idx += threads_for(KCP)) {
    const int ke = idx >> 4;
    tab[idx] = tab[ke * COPIES + (ke & 15)];
  }
}

// The aligned chunk of each B row holding column GRAN * g, or zeros past
// the range's end (g > w1) or past B.
template <int KCP>
__device__ __forceinline__ void load_step(uint4 (&v)[KCP], const uint8_t* brow, long long n,
                                          long long g, long long w1, const uint8_t* b_end) {
#pragma unroll
  for (int kk = 0; kk < KCP; ++kk) {
    const uintptr_t q = reinterpret_cast<uintptr_t>(brow + size_t(kk) * n + size_t(GRAN) * g);
    const uint4* chunk = reinterpret_cast<const uint4*>(q & ~uintptr_t(15));
    v[kk] = g <= w1 && reinterpret_cast<const uint8_t*>(chunk) < b_end ? load_l2_256(chunk)
                                                                      : make_uint4(0, 0, 0, 0);
  }
}

// One warp's range [w0, w1) of granules of batch element bb.
template <int KCP>
__device__ __forceinline__ void run_range(const Params& p, const unsigned char* smem, uint4* carry,
                                          long long bb, long long w0, long long w1,
                                          const uint8_t* b_end) {
  const int lane = threadIdx.x & 31;
  const unsigned lane_off = (lane & 15) * 8;  // this lane's copy
  const uint8_t* brow = p.b + (size_t(bb) * p.k + p.k0) * p.n;
  uint8_t* crow = p.c + (size_t(bb) * p.m + p.r0) * p.n;
  unsigned sh[KCP];
#pragma unroll
  for (int kk = 0; kk < KCP; ++kk) sh[kk] = reinterpret_cast<uintptr_t>(brow + size_t(kk) * p.n) & 15;

  uint4 cur[KCP], nxt[KCP];
  load_step<KCP>(cur, brow, p.n, w0 + lane, w1, b_end);
  for (long long gs = w0; gs <= w1; gs += 32) {
    const long long g = gs + lane;
    load_step<KCP>(nxt, brow, p.n, g + 32, w1, b_end);

    // lookups: column q of the granule accumulates T_k[B[k, q]] in acc[q]
    uint2 acc[GRAN];
#pragma unroll
    for (int kk = 0; kk < KCP; ++kk) {
      const uint4 hi = shfl4(lane == 0 ? nxt[kk] : cur[kk], (lane + 1) & 31);
      const uint4 v = window(cur[kk], hi, sh[kk]);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const unsigned char* tab = smem + kk * TABLE_BYTES;
#pragma unroll
      for (int q = 0; q < GRAN; ++q) {
        const uint32_t x = w[q >> 2];
        const int s = 8 * (q & 3) - 7;  // byte q & 3, times 128
        const unsigned off = ((s < 0 ? x << 7 : x >> s) & 0x7f80u) | lane_off;
        const uint2 t = *reinterpret_cast<const uint2*>(tab + off);
        if (kk == 0) {
          acc[q] = t;
        } else {
          acc[q].x ^= t.x;
          acc[q].y ^= t.y;
        }
      }
    }

    // repack: rows 0..3 from the low words, rows 4..7 from the high words
    uint4 row[ROWS];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t r[8];
      transpose4(acc[4 * j].x, acc[4 * j + 1].x, acc[4 * j + 2].x, acc[4 * j + 3].x,
                 r[0], r[1], r[2], r[3]);
      if (p.rows > 4) {
        transpose4(acc[4 * j].y, acc[4 * j + 1].y, acc[4 * j + 2].y, acc[4 * j + 3].y,
                   r[4], r[5], r[6], r[7]);
      } else {
        r[4] = r[5] = r[6] = r[7] = 0;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (j == 0) row[i].x = r[i];
        if (j == 1) row[i].y = r[i];
        if (j == 2) row[i].z = r[i];
        if (j == 3) row[i].w = r[i];
      }
    }

    // stores: lane l writes the aligned chunk holding its first column
    const int own_len = g < w1 ? int(min(LGRAN, p.n - GRAN * g)) : 0;
    const bool prev_ok = g > w0 && g <= w1;  // granule g - 1 is in the range
    const int prev_len = prev_ok ? int(min(LGRAN, p.n - GRAN * (g - 1))) : 0;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i >= p.rows) break;
      uint4 prev = shfl4(row[i], (lane + 31) & 31);
      if (lane == 0) prev = carry[i];
      uint8_t* ci = crow + size_t(i) * p.n;
      const int s = int(reinterpret_cast<uintptr_t>(ci) & 15);
      const uint4 chunk = s ? window(prev, row[i], 16 - s) : row[i];
      int lo = prev_ok ? 0 : s, hi;
      if (g > w1) {
        hi = 0;
      } else if (own_len > 0) {
        hi = s + min(own_len, 16 - s);
      } else {
        hi = max(0, s + prev_len - 16);
      }
      if (lo < hi) {
        uint4* dst = reinterpret_cast<uint4*>(ci + size_t(GRAN) * g - s);
        uint4 out = chunk;
        if (p.accumulate) {
          const uint4 old = *dst;
          out = make_uint4(out.x ^ old.x, out.y ^ old.y, out.z ^ old.z, out.w ^ old.w);
        }
        if (lo == 0 && hi == 16) {
          *dst = out;
        } else {
          store_part(reinterpret_cast<uint8_t*>(dst), out, lo, hi);
        }
      }
    }
    __syncwarp();
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i < p.rows) carry[i] = row[i];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KCP; ++kk) cur[kk] = nxt[kk];
  }
}

template <int KCP>
__global__ void __launch_bounds__(threads_for(KCP), 1) gf256_matmul_kernel(const Params p) {
  constexpr int WARPS = threads_for(KCP) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* carry = reinterpret_cast<uint4*>(smem + KCP * TABLE_BYTES) + (threadIdx.x >> 5) * ROWS;
  const int warp = threadIdx.x >> 5;
  const long long per_elem = (p.n + GRAN - 1) / GRAN;  // granules a batch element
  const long long total = p.batch * per_elem;
  const long long g_end = total * (blockIdx.x + 1) / gridDim.x;
  const uint8_t* b_end = p.b + size_t(p.batch) * p.k * p.n;
  for (long long g = total * blockIdx.x / gridDim.x; g < g_end;) {
    const long long bb = g / per_elem;
    const long long first = bb * per_elem;
    const long long seg_end = min(g_end, first + per_elem);
    __syncthreads();  // every warp is done with the previous tables
    build_tables<KCP>(smem, p, bb);
    __syncthreads();
    const long long h0 = g - first, h = seg_end - g;
    const long long w0 = h0 + h * warp / WARPS, w1 = h0 + h * (warp + 1) / WARPS;
    if (w0 < w1) run_range<KCP>(p, smem, carry, bb, w0, w1, b_end);
    g = seg_end;
  }
}

template <int KCP>
cudaError_t launch_pass(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(KCP);
  cudaError_t err = cudaFuncSetAttribute(gf256_matmul_kernel<KCP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  constexpr int THREADS = threads_for(KCP);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf256_matmul_kernel<KCP>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long granules = p.batch * ((p.n + GRAN - 1) / GRAN);
  const long long want = (granules + THREADS - 1) / THREADS;  // a step of every warp
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = int(want < 1 ? 1 : (want < most ? want : most));
  gf256_matmul_kernel<KCP><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch(const void* a, const void* b, void* c, long long batch, int m, int k, long long n,
           void* stream) {
  if (batch < 1 || m < 1 || k < 1 || n < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < m; r0 += ROWS) {
    for (int k0 = 0; k0 < k; k0 += KC) {
      const Params p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
                     static_cast<uint8_t*>(c), batch, n, m, k, r0,
                     m - r0 < ROWS ? m - r0 : ROWS, k0, k0 > 0};
      cudaError_t err;
      switch (k - k0 < KC ? k - k0 : KC) {
        case 1: err = launch_pass<1>(p, s); break;
        case 2: err = launch_pass<2>(p, s); break;
        case 3: err = launch_pass<3>(p, s); break;
        case 4: err = launch_pass<4>(p, s); break;
        case 5: err = launch_pass<5>(p, s); break;
        case 6: err = launch_pass<6>(p, s); break;
        default: err = launch_pass<7>(p, s); break;
      }
      if (err != cudaSuccess) return int(err);
    }
  }
  return 0;
}

}  // namespace

// All arrays are contiguous uint8 on the current device. Returns the
// cudaError_t of the launches (0 on success).

// Kernel B2: a (m, k), b (k, n) -> c (m, n).
extern "C" int gf256_matmul_launch(const void* a, const void* b, void* c, int m, int k,
                                   long long n, void* stream) {
  return launch(a, b, c, 1, m, k, n, stream);
}

// Kernel B3: a (batch, m, k), b (batch, k, n) -> c (batch, m, n).
extern "C" int gf256_matmul_batched_launch(const void* a, const void* b, void* c,
                                           long long batch, int m, int k, long long n,
                                           void* stream) {
  return launch(a, b, c, batch, m, k, n, stream);
}
