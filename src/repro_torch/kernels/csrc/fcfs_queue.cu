// Exact FCFS queue walk for a batch of independent seeds, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fcfs_scan_pallas` in
// src/repro/kernels/fcfs_queue.py (body `_fcfs_kernel`, update `_step`).
// Per request i of seed s, over the m nodes:
//
//     start_j  = max(t_i, dep_j)
//     finish_j = start_j + service_ij
//     dep_j   <- finish_j            where mask_ij
//     busy_j  += service_ij          where mask_ij
//     latency_i = max_{mask_ij} finish_j - t_i   (-inf for an empty mask)
//
// Design. The walk is sequential in the request axis and independent across
// seeds, so one warp owns one seed for the whole walk. Lane l owns nodes
// l, l+32, ..., and keeps their `dep` and `busy` in registers from the
// first request to the last; only the (S, N) latency and the final (S, m)
// carries are written back. The masked maximum of `finish` is a butterfly
// of __shfl_xor_sync + fmaxf starting from -INFINITY; lane 0 stores the
// latency. Blocks of WARPS warps cover consecutive seeds and share nothing.
// The adds and maxes are the reference's own operations in the same order,
// so results are bitwise equal to its `ref` backend: build without
// --use_fast_math. Inputs carry no NaN; note that fmaxf drops a NaN operand
// where jnp.max would propagate it.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). Bytes moved: each input read once and each output
// written once, S*N*(8 + 5m) + 16*S*m. At S = 256, N = 100000, m = 12 that
// is 1.74 GB, 0.52 ms at 3.35 TB/s. Operations are about 6 per
// (request, node), far below the float32 rate, so bytes bound it. In
// practice the serial walk over N steps, with only S/132 warps per SM to
// hide each step's load latency, bounds it first (PERF.md has its time);
// prefetching request slices with cp.async and packing more seeds per SM
// is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 2;  // warps (= seeds) per block
constexpr int MAX_Q = 8;  // nodes per lane, so m <= 32 * MAX_Q

// Q is the number of nodes each lane owns. Two instances are built: Q = 1
// for m <= 32 (every width the repo runs) and Q = MAX_Q for wider
// clusters. A single MAX_Q instance, whose unused node slots are skipped
// by the `j < m` test, ran slower at m = 12 (PERF.md has both times).
template <int Q>
__global__ void fcfs_scan_kernel(const float* __restrict__ t,
                                 const uint8_t* __restrict__ masks,
                                 const float* __restrict__ service,
                                 const float* __restrict__ dep0,
                                 const float* __restrict__ busy0,
                                 float* __restrict__ latency,
                                 float* __restrict__ dep_out,
                                 float* __restrict__ busy_out,
                                 int s, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int seed = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (seed >= s) return;  // warp-uniform: the whole warp leaves together

  float dep[Q];
  float busy[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = lane + 32 * q;
    dep[q] = j < m ? dep0[(size_t)seed * m + j] : 0.0f;
    busy[q] = j < m ? busy0[(size_t)seed * m + j] : 0.0f;
  }

  const float* t_s = t + (size_t)seed * n;
  const uint8_t* mask_s = masks + (size_t)seed * n * m;
  const float* srv_s = service + (size_t)seed * n * m;
  float* lat_s = latency + (size_t)seed * n;

#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float ti = t_s[i];
    float fmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = lane + 32 * q;
      if (j < m) {
        const size_t off = (size_t)i * m + j;
        const float srv = srv_s[off];
        const float finish = fmaxf(ti, dep[q]) + srv;
        if (mask_s[off]) {
          dep[q] = finish;
          busy[q] = busy[q] + srv;
          fmax = fmaxf(fmax, finish);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      fmax = fmaxf(fmax, __shfl_xor_sync(0xffffffffu, fmax, o));
    }
    if (lane == 0) lat_s[i] = fmax - ti;
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = lane + 32 * q;
    if (j < m) {
      dep_out[(size_t)seed * m + j] = dep[q];
      busy_out[(size_t)seed * m + j] = busy[q];
    }
  }
}

}  // namespace

// All arrays are contiguous on the current device: t (s, n) float32,
// masks (s, n, m) uint8, service (s, n, m) float32, dep0 / busy0 (s, m)
// float32; outputs latency (s, n), dep (s, m), busy (s, m) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fcfs_scan_launch(const void* t, const void* masks,
                                const void* service, const void* dep0,
                                const void* busy0, void* latency, void* dep,
                                void* busy, int s, int n, int m,
                                void* stream) {
  if (s <= 0 || n < 0 || m <= 0 || m > 32 * MAX_Q) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(32 * WARPS);
  const dim3 grid((s + WARPS - 1) / WARPS);
  auto kernel = m <= 32 ? fcfs_scan_kernel<1> : fcfs_scan_kernel<MAX_Q>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)masks, (const float*)service,
      (const float*)dep0, (const float*)busy0, (float*)latency, (float*)dep,
      (float*)busy, s, n, m);
  return (int)cudaGetLastError();
}
