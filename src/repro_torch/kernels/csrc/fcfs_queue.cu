// Exact FCFS queue walk for a batch of independent seeds, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fcfs_scan_pallas` in
// src/repro/kernels/fcfs_queue.py:108 (call :142, update `_step` :60).
// Per request i of seed s, over the m nodes:
//
//     start_j  = max(t_i, dep_j)
//     finish_j = start_j + service_ij
//     dep_j   <- finish_j            where mask_ij
//     busy_j  += service_ij          where mask_ij
//     latency_i = max_{mask_ij} finish_j - t_i   (-inf for an empty mask)
//
// Only the carried dep_j chain is serial; everything else is taken off it.
//
// Design. One block of 4 warps per seed: warp 0 walks, warps 1-3 (the
// helpers) feed it. The requests are cut into slices of C (a multiple of
// 16; C = 224 at m = 12). For each slice the helpers
//   1. copy t[i0:i0+C], service[i0:i0+C, :] and mask[i0:i0+C, :], each
//      contiguous in device memory, into shared memory with 16-byte
//      cp.async, three slices ahead of the walk (a ring of 2 raw buffers);
//   2. rewrite the slice node-major for the walk, as pairs
//      (t', s') = (t_i, service_ij) where mask_ij (any non-zero byte, as
//      the twin's masks.bool()) and (-inf, 0) where not,
//      padded with (-inf, 0) to a multiple of 4 requests (a ring of 3);
//   3. after the walk, take latency_i = max_j finish_ij - t_i over the
//      masked j for all C requests in parallel and store them coalesced.
// Lane j of the walker owns node j (j, j+32, ... in the wide instance),
// keeps dep_j and busy_j in registers, and per request does
//     dep_j = max(t', dep_j) + s';   busy_j = busy_j + s'
// which is the twin's step: where unmasked, max(-inf, dep) + 0 is dep, and
// busy + 0 is what the twin's busy + where(mask, service, 0) adds. So the
// chain is two dependent operations a request, with no select and no
// predicate; the walker reads 2 requests' pairs in one 16-byte load and
// writes dep back over s' in one 16-byte store, for the helpers' max. No
// shuffle remains inside the serial loop. Max is exact, and the adds and
// maxes are the twin's own operations in its order, so latency and dep are
// bitwise equal to it: build without --use_fast_math. Inputs carry no NaN;
// note that fmaxf drops a NaN operand where jnp.max would propagate it.
// A seed's rows need not start on a 16-byte boundary (any N and m), so
// each range is copied from the 16-byte boundary below its first byte to
// the one above its last: an aligned 16-byte read that holds a byte of the
// tensor stays inside its mapped allocation, and the extra bytes are never
// used.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). Bytes moved: each input read once and each output
// written once, S*N*(8 + 5m) + 16*S*m. At S = 256, N = 100000, m = 12 that
// is 1.741 GB, 0.520 ms at 3.35 TB/s. Beside it stands the serial chain:
// N steps of max and add on dep, whatever the number of seeds. No table
// gives its latency, so chip_smoke.py times that chain alone on the card
// (phase 1) and prints it beside this kernel's time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // warp 0 walks, warps 1-3 copy, rewrite and reduce
constexpr int HELPERS = THREADS - 32;
constexpr int RAW = 2;        // raw slices: being rewritten, being copied
constexpr int WALK = 3;       // node-major slices: reduced, walked, being written
constexpr int MAX_Q = 8;      // nodes per lane, so m <= 32 * MAX_Q
constexpr int SMEM_BUDGET = 98304;  // bytes a block aims at: 2 blocks an SM

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }
// room for a range of `bytes` copied from the boundaries around it
__host__ __device__ inline int room(int bytes) { return round16(bytes + 32); }
__host__ __device__ inline int raw_bytes(int c, int m) {
  return room(4 * c) + room(4 * c * m) + room(c * m);
}
// t copy, then m node rows of c + 2 pairs (16-byte aligned, and row j
// starts j 16-byte words later in the bank cycle, so the walker's 16-byte
// loads are free of bank conflicts)
__host__ __device__ inline int walk_bytes(int c, int m) { return round16(4 * c) + 8 * m * (c + 2); }
// requests per slice: a multiple of 16 in [16, 1024]
__host__ __device__ inline int slice_len(int m) {
  const int c = SMEM_BUDGET / (RAW * (4 + 5 * m) + WALK * (4 + 8 * m)) / 16 * 16;
  return c < 16 ? 16 : (c > 1024 ? 1024 : c);
}
__host__ __device__ inline int smem_bytes(int c, int m) {
  return RAW * raw_bytes(c, m) + WALK * walk_bytes(c, m);
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(HELPERS) : "memory");
}

// Copy global bytes [src, src + bytes) into `dst` by helper `u`, from the
// 16-byte boundary below src: src[0] lands at dst + (src % 16).
__device__ __forceinline__ void stage(unsigned char* dst, const void* src, size_t bytes,
                                      int u) {
  const uintptr_t a = (uintptr_t)src, a0 = a & ~(uintptr_t)15;
  const int chunks = (int)((a + bytes - a0 + 15) / 16);
  for (int c = u; c < chunks; c += HELPERS)
    cp_async16(dst + 16 * c, reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)c));
}

// yes where `on` is all ones, no where it is 0
__device__ __forceinline__ float pick(uint32_t on, float yes, float no) {
  return __uint_as_float((__float_as_uint(yes) & on) | (__float_as_uint(no) & ~on));
}

// where `stage` put src[0]
template <typename T>
__device__ __forceinline__ const T* landed(const unsigned char* dst, const T* src) {
  return reinterpret_cast<const T*>(dst + ((uintptr_t)src & 15));
}

// One seed's slices in shared memory, and the helpers' work on them.
struct Ring {
  unsigned char* smem;
  const float* t;        // the seed's rows of the inputs
  const uint8_t* mask;
  const float* srv;
  float* latency;        // and of the output
  int n, m, c, n_slices;

  __device__ __forceinline__ int len(int k) const { return min(c, n - k * c); }
  __device__ __forceinline__ int row() const { return c + 2; }  // pairs per node row
  __device__ __forceinline__ unsigned char* raw(int k) const {
    return smem + (k % RAW) * raw_bytes(c, m);
  }
  __device__ __forceinline__ unsigned char* walk(int k) const {
    return smem + RAW * raw_bytes(c, m) + (k % WALK) * walk_bytes(c, m);
  }
  __device__ __forceinline__ float* t_copy(int k) const {
    return reinterpret_cast<float*>(walk(k));
  }
  __device__ __forceinline__ float2* pairs(int k) const {
    return reinterpret_cast<float2*>(walk(k) + round16(4 * c));
  }

  // helper u: copy slice k into its raw buffer
  __device__ __forceinline__ void issue(int k, int u) const {
    if (k < n_slices) {
      const size_t i0 = (size_t)k * c;
      unsigned char* buf = raw(k);
      stage(buf, t + i0, 4 * (size_t)len(k), u);
      stage(buf + room(4 * c), srv + i0 * m, 4 * (size_t)len(k) * m, u);
      stage(buf + room(4 * c) + room(4 * c * m), mask + i0 * m, (size_t)len(k) * m, u);
    }
    cp_async_commit();
  }

  // helper u: raw slice k -> node-major pairs
  __device__ __forceinline__ void rewrite(int k, int u) const {
    const size_t i0 = (size_t)k * c;
    const unsigned char* buf = raw(k);
    const float* tr = landed(buf, t + i0);
    const float* sr = landed(buf + room(4 * c), srv + i0 * m);
    const uint8_t* mr = landed(buf + room(4 * c) + room(4 * c * m), mask + i0 * m);
    const int cn = len(k), cp = (cn + 3) & ~3;
    float2* pr = pairs(k);
    float* tc = t_copy(k);
    for (int i = u; i < cp; i += HELPERS) {
      // rows [cn, cp) read leftover bytes of the buffer and are switched off
      const uint32_t in = i < cn ? ~0u : 0u;
      const float ti = tr[i];
      if (in) tc[i] = ti;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const uint32_t on = in & (mr[i * m + j] ? ~0u : 0u);  // any non-zero byte is true
        pr[j * row() + i] = make_float2(pick(on, ti, -INFINITY), pick(on, sr[i * m + j], 0.0f));
      }
    }
  }

  // helper u: the latencies of walked slice k
  __device__ __forceinline__ void reduce(int k, int u) const {
    const float2* pr = pairs(k);
    const float* tc = t_copy(k);
    float* lat = latency + (size_t)k * c;
    for (int i = u; i < len(k); i += HELPERS) {
      float fmax = -INFINITY;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float2 x = pr[j * row() + i];  // (t_i, finish) where masked
        fmax = fmaxf(fmax, x.x == -INFINITY ? -INFINITY : x.y);
      }
      lat[i] = fmax - tc[i];
    }
  }
};

// Q is the number of nodes each lane of the walker owns. Two instances are
// built: Q = 1 for m <= 32 (every width the repo runs) and Q = MAX_Q for
// wider clusters.
template <int Q>
__global__ void __launch_bounds__(THREADS)
fcfs_scan_kernel(const float* __restrict__ t, const uint8_t* __restrict__ masks,
                 const float* __restrict__ service, const float* __restrict__ dep0,
                 const float* __restrict__ busy0, float* __restrict__ latency,
                 float* __restrict__ dep_out, float* __restrict__ busy_out, int n,
                 int m, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  const int u = threadIdx.x - 32;  // helper index
  const size_t seed = blockIdx.x;
  const int n_slices = (n + c - 1) / c;
  const Ring ring{smem, t + seed * n, masks + seed * n * m, service + seed * n * m,
                  latency + seed * n, n, m, c, n_slices};

  float dep[Q], busy[Q];
  int node[Q];
  bool own[Q];
  if (walker) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      own[q] = lane + 32 * q < m;
      node[q] = min(lane + 32 * q, m - 1);  // a lane past m walks node m - 1, stores nothing
      dep[q] = dep0[seed * m + node[q]];
      busy[q] = busy0[seed * m + node[q]];
    }
  } else {
    ring.issue(0, u);
    ring.issue(1, u);
    if (n_slices > 0) {
      cp_async_wait1();  // slice 0 has landed
      helpers_sync();
      ring.rewrite(0, u);
      helpers_sync();  // every helper is done with raw slice 0
    }
    ring.issue(2, u);
  }

  for (int k = 0; k <= n_slices; ++k) {
    if (!walker) cp_async_wait1();  // slice k + 1 has landed
    __syncthreads();  // ... for every helper; slice k is rewritten, k - 1 walked
    if (walker) {
      if (k < n_slices) {
        const int half = ((ring.len(k) + 3) & ~3) / 2;  // 16-byte words: 2 requests each
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4* p = reinterpret_cast<float4*>(ring.pairs(k) + node[q] * ring.row());
          float d = dep[q], b = busy[q];
#pragma unroll 4
          for (int w = 0; w < half; w += 2) {  // 4 requests
            float4 x = p[w], y = p[w + 1];
            d = fmaxf(x.x, d) + x.y;
            b = b + x.y;
            x.y = d;
            d = fmaxf(x.z, d) + x.w;
            b = b + x.w;
            x.w = d;
            d = fmaxf(y.x, d) + y.y;
            b = b + y.y;
            y.y = d;
            d = fmaxf(y.z, d) + y.w;
            b = b + y.w;
            y.w = d;
            if (own[q]) {
              p[w] = x;
              p[w + 1] = y;
            }
          }
          dep[q] = d;
          busy[q] = b;
        }
      }
    } else {
      if (k >= 1) ring.reduce(k - 1, u);
      if (k + 1 < n_slices) ring.rewrite(k + 1, u);
      helpers_sync();  // every helper is done with raw slice k + 1
      ring.issue(k + 3, u);
    }
  }

  if (walker) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (own[q]) {
        dep_out[seed * m + node[q]] = dep[q];
        busy_out[seed * m + node[q]] = busy[q];
      }
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
  const int c = slice_len(m);
  const int bytes = smem_bytes(c, m);
  auto kernel = m <= 32 ? fcfs_scan_kernel<1> : fcfs_scan_kernel<MAX_Q>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<s, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)masks, (const float*)service,
      (const float*)dep0, (const float*)busy0, (float*)latency, (float*)dep,
      (float*)busy, n, m, c);
  return (int)cudaGetLastError();
}
