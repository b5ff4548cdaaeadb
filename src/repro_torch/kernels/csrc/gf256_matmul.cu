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
// kernel multiplies by log/exp table lookup (zfec's idiom). GF(256)
// arithmetic is exact, so both give the same bytes, and the kernel is held
// bitwise against its xtime plain twin (kernels/gf256_matmul.py).
//
// Design.
// * Each block builds the 256-entry log and the exp table in shared memory
//   (thread t computes g^t), with log[0] = LOG_ZERO chosen so that
//   exp[log a + LOG_ZERO] == 0: a zero byte of B needs no branch. A zero
//   entry of A is skipped by a branch that is uniform across the block.
// * A block covers COLS = 256 x 16 consecutive columns of one batch
//   element; each thread owns a run of 16 consecutive columns. Rows are
//   taken ROWS = 8 at a time, with the 8 x 16 output bytes in registers,
//   so for every M <= 8 (all the codec's shapes) each byte of B is read
//   from device memory once. log(A) of the current 8 rows is staged in
//   shared memory once per (block, batch element, row pass).
// * Per k the thread loads its 16 bytes of B row k: one 16-byte load where
//   the address is 16-byte aligned, otherwise five aligned 4-byte loads
//   joined with funnel shifts (codec rows have odd widths), and bytes one
//   at a time at the row's end. It looks up their 16 logs once and reuses
//   them for all rows. Stores are 16-byte, 4-byte or 1-byte by alignment.
// * Every offset is size_t: the (12, 6) encode's B operand is 2.1e9 bytes,
//   2.3 % under 2^31. Any M >= 1, 1 <= K <= 256 and any N >= 1.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). Bytes: each input read once and each output written
// once, B*(M*K + K*N + M*N); for the §V.B (12, 6) encode group that is
// 4.19 GB, 1.25 ms at 3.35 TB/s. Operations: K multiply-adds per output
// byte, each an add of logs, an exp lookup and an xor, plus one log lookup
// per byte of B; 4.0e10 for that group, 0.59 ms at 67 Tops/s, so bytes
// bind by that count. The shared-memory lookups themselves (1.5e10 for
// that group, at 32 per SM per clock about 1.8 ms before bank conflicts
// of the random table indices) are the likelier limit in practice;
// PERF.md has the measured times. Replicating the tables per bank and
// wider runs are later work.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // threads per block; also builds the tables
constexpr int RUN = 16;               // consecutive output bytes per thread
constexpr int COLS = THREADS * RUN;   // columns per block
constexpr int ROWS = 8;               // output rows per pass, accumulated in registers
constexpr int MAX_K = 256;
constexpr unsigned POLY = 0x11d;
constexpr unsigned LOG_ZERO = 511;    // log[0]; LOG_ZERO + 254 < EXP_SIZE
constexpr int EXP_SIZE = 768;         // exp doubled to 510 entries, then zeros

// The 16 bytes of `row` at columns j0..j0+15, packed little-endian into
// four words; columns at or past n read as 0.
__device__ __forceinline__ void load_run(const uint8_t* row, size_t j0, size_t n,
                                         uint32_t w[4]) {
  const uint8_t* p = row + j0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if (j0 + RUN <= n && (addr & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if (j0 + RUN + 4 <= n) {
    const uint32_t* base = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
    const unsigned shift = 8 * unsigned(addr & 3);
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = base[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], shift);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      if (j0 + q < n) w[q >> 2] |= uint32_t(p[q]) << (8 * (q & 3));
    }
  }
}

// Store the packed run to `row` at columns j0.., cut at column n.
__device__ __forceinline__ void store_run(uint8_t* row, size_t j0, size_t n,
                                          const uint32_t w[4]) {
  uint8_t* p = row + j0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if (j0 + RUN <= n && (addr & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (j0 + RUN <= n && (addr & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      if (j0 + q < n) p[q] = uint8_t(w[q >> 2] >> (8 * (q & 3)));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gf256_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                    uint8_t* __restrict__ c, int batch, int m, int k, size_t n) {
  __shared__ uint8_t s_exp[EXP_SIZE];
  __shared__ uint16_t s_log[256];
  __shared__ uint16_t s_loga[ROWS * MAX_K];

  const int t = threadIdx.x;
  if (t < 255) {  // exp[t] = g^t for the generator g = 2
    unsigned x = 1;
    for (int i = 0; i < t; ++i) {
      x <<= 1;
      if (x & 0x100) x ^= POLY;
    }
    s_exp[t] = uint8_t(x);
    s_exp[t + 255] = uint8_t(x);
    s_log[x] = uint16_t(t);
  } else {
    s_log[0] = LOG_ZERO;
  }
  for (int i = 510 + t; i < EXP_SIZE; i += THREADS) s_exp[i] = 0;

  const size_t j0 = (size_t(blockIdx.x) * THREADS + t) * RUN;
  for (int bb = blockIdx.y; bb < batch; bb += gridDim.y) {
    const uint8_t* a_b = a + size_t(bb) * m * k;
    const uint8_t* b_b = b + size_t(bb) * k * n;
    uint8_t* c_b = c + size_t(bb) * m * n;
    for (int r0 = 0; r0 < m; r0 += ROWS) {
      const int rows = min(ROWS, m - r0);
      __syncthreads();  // tables ready; the previous pass is done with s_loga
      for (int i = t; i < rows * k; i += THREADS) {
        s_loga[i] = s_log[a_b[size_t(r0) * k + i]];
      }
      __syncthreads();
      if (j0 >= n) continue;  // past the row's end; still joins the syncs

      uint32_t acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0;
      }
      for (int kk = 0; kk < k; ++kk) {
        uint32_t w[4];
        load_run(b_b + size_t(kk) * n, j0, n, w);
        unsigned lb[RUN];
#pragma unroll
        for (int q = 0; q < RUN; ++q) lb[q] = s_log[(w[q >> 2] >> (8 * (q & 3))) & 0xff];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const unsigned la = r < rows ? s_loga[r * k + kk] : LOG_ZERO;
          if (la != LOG_ZERO) {  // A[r, kk] != 0; the same for the whole block
#pragma unroll
            for (int q = 0; q < RUN; ++q) {
              acc[r][q >> 2] ^= uint32_t(s_exp[la + lb[q]]) << (8 * (q & 3));
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) store_run(c_b + size_t(r0 + r) * n, j0, n, acc[r]);
      }
    }
  }
}

int launch(const void* a, const void* b, void* c, int batch, int m, int k,
           long long n, void* stream) {
  const long long blocks = (n + COLS - 1) / COLS;
  if (batch < 1 || m < 1 || k < 1 || k > MAX_K || n < 1 || blocks > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid(unsigned(blocks), unsigned(batch < 65535 ? batch : 65535));
  gf256_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(c), batch, m, k, size_t(n));
  return int(cudaGetLastError());
}

}  // namespace

// All arrays are contiguous uint8 on the current device. Returns the
// cudaError_t of the launch (0 on success).

// Kernel B2: a (m, k), b (k, n) -> c (m, n).
extern "C" int gf256_matmul_launch(const void* a, const void* b, void* c, int m,
                                   int k, long long n, void* stream) {
  return launch(a, b, c, 1, m, k, n, stream);
}

// Kernel B3: a (batch, m, k), b (batch, k, n) -> c (batch, m, n); the batch
// is the grid's y axis.
extern "C" int gf256_matmul_batched_launch(const void* a, const void* b, void* c,
                                           int batch, int m, int k, long long n,
                                           void* stream) {
  return launch(a, b, c, batch, m, k, n, stream);
}
