// Causal / sliding-window GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py:84 (body `_kernel` :37). For q
// (B, Tq, H, hd) and k/v (B, Tk, KH, hd), G = H / KH, query head h reading
// KV head h / G:
//
//     s[iq, ik] = (q[iq] . k[ik]) * scale              (float32)
//     valid     = (ik <= iq if causal) && (ik > iq - window if windowed)
//     out[iq]   = sum_ik softmax(s)[ik] v[ik]           over the valid keys
//
// with an online softmax (running max m, normaliser l, accumulator acc) and
// out = acc / max(l, 1e-30), cast to the input type (float32 or bfloat16).
// Keys [Tk, Tkp) are the reference's zero padding to its key block; they
// are masked only by the causal test, as there. A row with no valid key at
// all gets equal weights on [0, Tkp), which is what the reference's
// all-NEG row leaves (NEG = -1e30 is finite, so exp(NEG - NEG) = 1).
//
// Design. One block per (query tile, KV head, batch). Its 128 threads are
// 128 query rows: thread t owns query position tile*QT + t / G and group
// member t % G (QT = 128 / G), so all rows of the block read the same KV
// head. Each thread keeps its q row and its float32 accumulator in
// registers. K and V tiles of 64 keys are staged in shared memory as
// float32 and read by all threads of a warp at one address (a broadcast).
// Scores are taken 16 keys at a time into registers, then m, l and acc are
// updated once per 16 keys. Keys outside a row's band get no weight
// (exp(-inf) = 0), so nothing outside the band reaches acc: a row never
// sees the reference's NEG "garbage", which its later rescaling by
// alpha = exp(NEG - m) = 0 would wipe anyway. The block walks only the key
// tiles that intersect some row's band, and a warp skips a 16-key step
// that no row of it can see, so most of the upper triangle is never
// computed. Query tiles are issued last-first: under a causal mask the
// last tiles carry the most keys. With bfloat16 inputs p is rounded to
// bfloat16 before it multiplies v, as the reference's p.astype(v.dtype).
// Only the final row is written; padded query rows are never stored.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). At SmolLM-135M's prefill, (B, T, H, KH, hd) =
// (4, 2016, 9, 3, 64) in float32: bytes q + k + v + out = 49.5 MB, 14.8 us
// at 3.35 TB/s; the causal band alone is 2 * 2 * B*H*T(T+1)/2 * hd =
// 1.87e10 FLOP, 0.280 ms at 67 TFLOP/s outside the tensor cores. So
// operations bind. This kernel uses no tensor cores; wgmma at the TF32
// rate (495 TFLOP/s, 0.038 ms) is later work, as is reusing each shared
// memory load for more than one query row.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // query rows per block
constexpr int KT = 64;        // keys per shared-memory tile
constexpr int KC = 16;        // keys per online-softmax step
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p as the reference's p.astype(v.dtype) leaves it
__device__ __forceinline__ float as_v(float p, const float*) { return p; }
__device__ __forceinline__ float as_v(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int tq, int tk, int tkp, int h, int kh, float scale,
                       int causal, int has_window, int window) {
  __shared__ __align__(16) float ks[KT * HD];
  __shared__ __align__(16) float vs[KT * HD];
  __shared__ int band_lo, band_hi;

  const int g = h / kh;
  const int qt = THREADS / g;  // query positions per block
  const int n_tiles = (tq + qt - 1) / qt;
  const int tile = n_tiles - 1 - (int)blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int iq = tile * qt + t / g;
  const bool active = t < qt * g && iq < tq;

  // this row's band [lo, hi) of keys in [0, tkp); empty for idle threads
  int lo = 0, hi = 0;
  bool all_masked = false;
  if (active) {
    hi = causal ? min(tkp, iq + 1) : tkp;
    if (has_window) lo = max(0, iq - window + 1);
    if (lo >= hi) {  // every key masked: equal weights, as the reference
      all_masked = true;
      lo = 0;
      hi = tkp;
    }
  }
  if (t == 0) {
    band_lo = INT_MAX;
    band_hi = 0;
  }
  __syncthreads();
  if (active && lo < hi) {
    atomicMin(&band_lo, lo);
    atomicMax(&band_hi, hi);
  }
  __syncthreads();
  const int blo = band_lo, bhi = band_hi;

  const size_t row = active ? ((size_t)b * tq + iq) * h + (size_t)kvh * g + t % g : 0;
  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? to_f(q[row * HD + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  for (int k0 = blo; k0 < bhi; k0 += KT) {
    const int kn = min(KT, bhi - k0);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = t; i < KT * HD; i += THREADS) {
      const int j = i / HD, ik = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (j < kn && ik < tk) {
        const size_t off = (((size_t)b * tk + ik) * kh + kvh) * HD + i % HD;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    for (int c = 0; c < kn; c += KC) {
      const int c0 = k0 + c;
      // warp-uniform: skip 16 keys that no row of this warp can see
      if (!__any_sync(0xffffffffu, c0 < hi && c0 + KC > lo)) continue;
      float s[KC];
      float smax = NEG;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (c + j) * HD);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 x = kr[d];
          dot = fmaf(qr[4 * d], x.x, dot);
          dot = fmaf(qr[4 * d + 1], x.y, dot);
          dot = fmaf(qr[4 * d + 2], x.z, dot);
          dot = fmaf(qr[4 * d + 3], x.w, dot);
        }
        const int ik = c0 + j;
        const bool valid = c + j < kn && ik >= lo && ik < hi;
        s[j] = valid ? (all_masked ? 0.f : dot * scale) : -INFINITY;
        smax = fmaxf(smax, s[j]);
      }
      const float m_new = fmaxf(m, smax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[j] - m_new);  // 0 outside the band
        l += p;
        const float pv = as_v(p, q);
        const float4* vr = reinterpret_cast<const float4*>(vs + (c + j) * HD);
#pragma unroll
        for (int d = 0; d < HD / 4; ++d) {
          const float4 x = vr[d];
          acc[4 * d] = fmaf(pv, x.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(pv, x.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(pv, x.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(pv, x.w, acc[4 * d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) put(out + row * HD + d, acc[d] / den);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out,
                         int b, int tq, int tk, int tkp, int h, int kh, int hd,
                         float scale, int causal, int has_window, int window,
                         cudaStream_t stream) {
  const int qt = THREADS / (h / kh);
  const dim3 grid((tq + qt - 1) / qt, kh, b);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
#define FA_LAUNCH(HD)                                                           \
  flash_attention_kernel<T, HD><<<grid, THREADS, 0, stream>>>(                  \
      qq, kk, vv, oo, tq, tk, tkp, h, kh, scale, causal, has_window, window); \
  break;
  switch (hd) {
    case 8: FA_LAUNCH(8)
    case 16: FA_LAUNCH(16)
    case 32: FA_LAUNCH(32)
    case 64: FA_LAUNCH(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; no synchronise, no allocation. dtype 0 is float32,
// 1 bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int tq, int tk, int tkp,
                                      int h, int kh, int hd, int dtype, float scale,
                                      int causal, int has_window, int window,
                                      void* stream) {
  if (b < 1 || b > 65535 || tq < 1 || tk < 0 || tkp < tk || kh < 1 || kh > 65535 ||
      h < kh || h % kh != 0 || h / kh > THREADS || (has_window && window < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(q, k, v, out, b, tq, tk, tkp, h, kh, hd, scale,
                                    causal, has_window, window, s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, out, b, tq, tk, tkp, h, kh, hd,
                                            scale, causal, has_window, window, s);
  return (int)cudaErrorInvalidValue;
}
