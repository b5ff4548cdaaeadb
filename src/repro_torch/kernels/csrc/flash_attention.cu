// Causal / sliding-window GQA flash attention (forward), for Hopper (sm_90a),
// on the tensor cores through mma.sync.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py:84 (body `_kernel` :37). For q
// (B, Tq, H, hd), k (B, Tk, KH, hd) and v (B, Tk, KH, vd), G = H / KH,
// query head h reading KV head h / G:
//
//     s[iq, ik] = (q[iq] . k[ik]) * scale              (float32)
//     valid     = (ik <= iq if causal) && (ik > iq - window if windowed)
//     out[iq]   = sum_ik softmax(s)[ik] v[ik]           over the valid keys
//
// with an online softmax (running max m, normaliser l, accumulator acc) and
// out (B, Tq, H, vd) = acc / max(l, 1e-30), cast to the input type (float32
// or bfloat16). The reference's kernel takes one width (vd = hd); its lax
// chunked_sdpa (src/repro/models/attention_opt.py:30), which the kernel
// stands for on the model path, also takes vd != hd, and MLA (DeepSeek-V3)
// runs hd = 192 (nope 128 + rope 64) against vd = 128. RecurrentGemma's
// local layers run hd = vd = 256 (MQA: G = 10 query heads on one KV head).
// Keys [Tk, Tkp) are the reference's zero padding to its key block; they
// are masked only by the causal test, as there. A row with no valid key at
// all gets equal weights on [0, Tkp), which is what the reference's
// all-NEG row leaves (NEG = -1e30 is finite, so exp(NEG - NEG) = 1). A key
// outside a row's band gets score -inf and p = 0, so nothing outside the
// band reaches acc (m starts at NEG, so exp(-inf - m) is 0, never NaN).
//
// Design (FlashAttention-2's forward). A row is a (position, group member)
// pair of one KV head; the rows of all positions, in order, are cut into
// blocks of 64, so GQA's G query heads share every K/V tile and any G fits.
// One block per (row tile, KV head, batch), 4 warps, 16 rows a warp; row
// tiles are issued last-first, since under a causal mask they carry the
// most keys. Rows past Tq compute but never store. K and V tiles of 64 keys
// are copied into shared memory by 16-byte cp.async (keys past Tk
// zero-filled) in a 2-stage ring: the next tile's copy is in flight while
// this tile is computed. The block walks only the key tiles inside the
// union of its rows' bands [band_lo, band_hi); a warp skips a tile that
// none of its rows can see, and applies the mask only on tiles that cut
// some row's band.
//
// Products. S = Q K^T and O += P V are m16n8 tiles of
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for float32, with
// float32 accumulators in registers. One TF32 pass keeps 11 bits of each
// operand, too few for the 2e-5 tolerance against the float32 twin, so each
// operand x is split as big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big)
// and each product is taken as small*big + big*small + big*big, small terms
// first (CUTLASS's 3xTF32), which is float32-accurate at 3x the TF32 work.
// The rounding is two integer operations (`to_tf32`), bit for bit the
// conversion instruction's on finite inputs. Q is split once, as it is
// loaded (big kept in registers, small parked in shared memory); K and V
// are split as they are read from shared memory, by each warp for its own
// fragments. The bfloat16 instance runs
// mma.sync...m16n8k16.f32.bf16.bf16.f32 directly, and rounds p to bfloat16
// before P V, as the reference's p.astype(v.dtype).
//
// The troubles, and what this file does about them:
// - The m16n8 accumulator of S gives a thread columns 2c, 2c+1 of each
//   8-key group, but the m16n8k8 A operand wants columns c, c+4. P stays
//   in registers: within each group of 8 keys, A's column c is key 2c and
//   column c+4 is key 2c+1, and V's B fragment is read in the same order
//   (rows 2c and 2c+1 of the group), so the sum over keys is unchanged.
//   (m16n8k16 bf16 needs no permutation: its A layout is the accumulator's.)
// - Bank conflicts: K rows are padded to hd + 4 floats and V rows to
//   vd + 4 (hd + 8 and vd + 8 bfloat16, 16 bytes). K's B fragment reads
//   row 8nt+g, column 8kk+t, and V's reads rows 2t, 2t+1, column g; with
//   those strides the 32 lanes of a float32 read hit 32 distinct banks for
//   every width in {8, 16, 32, 64, 128, 192, 256} (a stride of 4 mod 32 words
//   puts lane (g, t) of K on bank 4g + t and of V on 8t + g).
// - (hd, vd) in (8, 8), (16, 16), (32, 32), (64, 64), (128, 128),
//   (192, 128) and (256, 256) are instantiated. At hd = 8 a float32
//   product is one k-step; the bfloat16 k16 step zero-fills columns >= hd.
// - Ragged T = 2016 with G = 3 is 6048 rows, 94.5 blocks of 64: the last
//   block's rows past Tq compute and never store.
// - Accuracy: the tensor cores add into their float32 accumulator more
//   coarsely than float32's round to nearest, and O runs over every key
//   tile of the row (32 tiles at T = 2016), so carried in the mma
//   accumulator it drifted past 2e-5 from the twin on the serve path. Each
//   tile's P V is taken from zero and added as O = fmaf(O, alpha, PV) in
//   float32; S is a fresh 64-term dot product each tile.
// - Registers at hd = 64: Q big 32 (Q small lives in shared memory), O 32,
//   this tile's P V 32, a 16 x 64 S tile 32, and the split fragments in
//   flight. Capped at 168 (3 blocks an SM) the float32 hd = 64 instance
//   spilled and ran slower, so the cap is 255 (__launch_bounds__(128, 2)):
//   2 blocks of 4 warps an SM. `ptxas -v` reports registers and spills for
//   every instance at build; none spills.
// - Registers and shared memory at hd = 128 (the GQA models' width): Q big
//   is 64 registers, O 64 and a tile's P V 64. A float32 ring of 64-key
//   tiles would take 135 KB, plus Q small's 32 KB: one block an SM, and S
//   would be 32 registers. The key tile there is 32 keys: 98 KB, two
//   blocks an SM, S 16 registers, and no spill at 255 registers. At
//   Phi-4-mini's prefill (tools/b4_hd128_variants.py) 64-key tiles ran
//   55 % slower, and folding each 8-column group of P V into O as soon as
//   it is summed (4 registers instead of 64) ran no faster.
// - Registers and shared memory at (hd, vd) = (192, 128), MLA's widths, in
//   float32: Q big is 96 registers (24 k-steps), O 64, a whole tile's P V
//   64 and S 16 at 32-key tiles: 240 before any fragment is in flight.
//   So this instance folds each 8-column group of P V into O as soon as it
//   is summed over the tile's keys (`fold_pv`): P is split once a tile and
//   P V costs 4 registers; each group is still summed from zero and added
//   by fmaf, the same sums in the same order. Its Q small is 48 KB, and a
//   32-key ring 84 KB, one block an SM; the key tile is 16 keys (a 41 KB
//   ring), two blocks an SM (`key_tile`: the largest of 64, 32 and 16 keys
//   that leaves room for two blocks, which also gives every other
//   instance its tile). At MLA's prefill (tools/b4_hd128_variants.py, an
//   H100 at 700 W) this design took 8.2-8.4 ms; 32-key tiles (one block
//   an SM) 11.6-11.8 ms, no fold (156 bytes of spill stores) 8.5-8.6 ms, and Q
//   big parked in shared memory (216 registers, one block an SM) 10.3-10.4
//   ms. The bfloat16 instance keeps a whole tile of P V (64-key tiles,
//   255 registers, no spill).
// - Registers and shared memory at (256, 256), RecurrentGemma's width, in
//   float32: Q big alone is 128 registers (32 k-steps) and O 128, the
//   whole file before S, P V or a fragment; and Q small's 64 KB beside a
//   16-key ring's 66.5 KB would pass two blocks' share of shared memory.
//   So the width is split across a pair of warps (`width_split`): a block
//   has 8 warps, two on each group of 16 rows; each warp holds Q's k-steps
//   and O's columns for its half of the width (64 + 64 registers, as at
//   hd = 128, and a whole tile of P V), computes S over its half of q/k,
//   and the pair adds its two partial S through shared memory once a key
//   tile (16 x KT floats a warp), so both take the same m, l and P; each
//   then computes P V for its own 128 columns of v. One block of 8 warps an
//   SM (`blocks_per_sm`), the same warps an SM as two blocks of 4: float32
//   reads 32-key tiles (a 130 KB ring, Q small 64 KB, partial S 16 KB; 210
//   KB), bfloat16 64-key tiles (132 KB + 32 KB). The other instances keep
//   split 1, two blocks an SM, and their code. At RecurrentGemma's forward
//   (tools/b4_hd128_variants.py, an H100 at 700 W) this design took
//   3.08-3.19 ms; 16-key tiles 3.12-3.24 ms, Q big parked in shared memory
//   with one warp a row group (4 warps an SM) 4.30-4.34 ms, and two
//   launches of a (256, 128) instance over v's halves, each recomputing S,
//   7.47-7.49 ms.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks, at the full
// 700 W power limit). At SmolLM-135M's prefill, (B, T, H, KH, hd) =
// (4, 2016, 9, 3, 64) in float32, the causal band is
// 2 * 2 * hd * B*H*T(T+1)/2 = 1.874e10 FLOP. Float32-accurate work on this
// design is 3 TF32 passes: 3 * 1.874e10 / 495e12 = 0.114 ms, the floor;
// one TF32 pass would be 0.038 ms, float32 outside the tensor cores
// 0.280 ms, and the bytes q + k + v + out (49.5 MB) 0.015 ms. At
// Phi-4-mini's, (4, 2016, 24, 8, 128), the band is 9.99e10 FLOP: three
// TF32 passes 0.606 ms, one pass 0.202 ms. At MLA's prefill in
// DeepSeek-V3, (B, T, H, KH, hd, vd) = (2, 2016, 128, 128, 192, 128), the
// band is 2 * (hd + vd) per pair, 3.331e11 FLOP: three TF32 passes 2.019
// ms, one pass 0.673 ms, the bytes (1.321 GB) 0.394 ms. At RecurrentGemma's
// local attention in a 2 x 4096-token forward, (2, 4096, 10, 1, 256) with
// window 2048, the window leaves 1.259e8 visible pairs (the causal mask
// alone 1.678e8), 2 * (hd + vd) = 1024 FLOP each, 1.289e11 FLOP: three TF32
// passes 0.781 ms, one pass 0.260 ms, the bytes (0.184 GB) 0.055 ms.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // (position, group member) rows per block
constexpr int STAGES = 2;
constexpr int MAX_GROUP = 128;    // the wrapper's MAX_GROUP
constexpr float NEG = -1e30f;

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }  // 16 bytes of row padding

// warps that share one group of 16 rows, each taking 1 / split of q/k's
// and of v's width: 2 where Q's fragments and O alone would fill the
// register file (float32 (256, 256): 128 + 128 registers), else 1
template <typename T, int HD, int VD>
__host__ __device__ constexpr int width_split() { return HD + VD > 384 ? 2 : 1; }

// the blocks an SM the launcher is built for (__launch_bounds__, shared
// memory): 2 of 4 warps, or 1 of 8 warps where the width is split; either
// way 8 warps an SM and at most 255 registers a thread
template <typename T, int HD, int VD>
__host__ __device__ constexpr int blocks_per_sm() { return 2 / width_split<T, HD, VD>(); }

// an SM's shared memory (228 KB, 1 KB of it the runtime's a block) per block
template <typename T, int HD, int VD>
__host__ __device__ constexpr int smem_budget() {
  return 233472 / blocks_per_sm<T, HD, VD>() - 1024;
}

// the K/V ring of `kt`-key tiles, for float32 Q small, and where the width
// is split, the pairs' partial S (16 rows x kt keys a warp)
template <typename T, int HD, int VD>
__host__ __device__ constexpr int smem_bytes_at(int kt) {
  return STAGES * kt * (HD + VD + 2 * pad<T>()) * (int)sizeof(T) +
         (std::is_same<T, float>::value ? WARPS * (HD / 8) * 32 * 16 : 0) +  // Q small
         (width_split<T, HD, VD>() > 1 ? WARPS * width_split<T, HD, VD>() * 16 * kt * 4 : 0);
}

// keys per shared-memory tile: the largest of 64, 32 and 16 whose shared
// memory fits blocks_per_sm() blocks an SM, 0 if none does (refused where
// the kernel is launched). Two blocks: float32 32 keys at hd = 128, 16 at
// (192, 128); one block of 8 warps at (256, 256): 32 keys in float32 (210
// KB), 64 in bfloat16 (164 KB)
template <typename T, int HD, int VD>
__host__ __device__ constexpr int key_tile() {
  return smem_bytes_at<T, HD, VD>(64) <= smem_budget<T, HD, VD>()   ? 64
         : smem_bytes_at<T, HD, VD>(32) <= smem_budget<T, HD, VD>() ? 32
         : smem_bytes_at<T, HD, VD>(16) <= smem_budget<T, HD, VD>() ? 16
                                                                    : 0;
}

template <typename T, int HD, int VD>
__host__ __device__ constexpr int smem_bytes() {
  return smem_bytes_at<T, HD, VD>(key_tile<T, HD, VD>());
}

// fold each 8-column group of P V into O as soon as it is summed, where
// Q's A fragments, O and a whole tile's P V would take more than 192
// registers (float32 at (192, 128): 96 + 64 + 64)
template <typename T, int HD, int VD>
__host__ __device__ constexpr bool fold_pv() {
  return (std::is_same<T, float>::value ? HD / 2 : (HD + 15) / 16 * 4) + VD > 192;
}

// cvt.rna.tf32.f32 on finite x (round to nearest, ties away from zero, 10
// mantissa bits kept) as two integer operations, bit for bit the
// instruction's result; the instruction itself ran slower in this kernel
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// small*big + big*small + big*big, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int HD, int VD>
__global__ void __launch_bounds__((THREADS * width_split<T, HD, VD>()),
                                  (blocks_per_sm<T, HD, VD>()))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int tq, int tk, int tkp, int h, int kh, float scale,
                       int causal, int has_window, int window) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int SPLIT = width_split<T, HD, VD>();  // warps sharing a row group's width
  constexpr int NTHREADS = THREADS * SPLIT;
  constexpr int HDW = HD / SPLIT, VDW = VD / SPLIT;  // a warp's q/k and v columns
  constexpr int KT = key_tile<T, HD, VD>();  // keys per shared-memory tile
  constexpr int NT = KT / 8;                // 8-key groups per tile
  constexpr int LDK = HD + pad<T>();        // shared row stride of K, elements
  constexpr int LDV = VD + pad<T>();        // shared row stride of V, elements
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int CPRK = HD / EPC, CPRV = VD / EPC;  // copies per key row of K, of V
  constexpr int CPR = CPRK > CPRV ? CPRK : CPRV;
  constexpr int DN = VDW / 8;               // the warp's 8-wide column groups of the output
  constexpr int KS = F32 ? HDW / 8 : (HDW + 15) / 16;  // the warp's k-steps of Q K^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  __shared__ int band_lo, band_hi;

  const int g_size = h / kh;
  const int n_tiles = (int)(((long long)tq * g_size + ROWS - 1) / ROWS);
  const int tile = n_tiles - 1 - (int)blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp_id = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's row group, and its share of the widths: q/k columns
  // [qc0, qc0 + HDW), v and output columns [vc0, vc0 + VDW)
  const int warp = SPLIT > 1 ? warp_id % WARPS : warp_id;
  const int share = SPLIT > 1 ? warp_id / WARPS : 0;
  const int qc0 = share * HDW, vc0 = share * VDW;
  const int gq = lane >> 2, tq4 = lane & 3;  // mma groupID, thread in group

  // the thread's two rows: r = 0 is row gq of the warp, r = 1 row gq + 8
  int lo[2], hi[2];
  bool active[2], all_masked[2];
  size_t row_off[2], out_off[2];  // q's and the output's row, elements
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long f = (long long)tile * ROWS + 16 * warp + gq + 8 * r;
    const int iq = (int)(f / g_size);
    active[r] = iq < tq;
    all_masked[r] = false;
    lo[r] = INT_MAX;  // an idle row sees no key
    hi[r] = INT_MIN;
    row_off[r] = out_off[r] = 0;
    if (active[r]) {
      const size_t row = ((size_t)b * tq + iq) * h + (size_t)kvh * g_size + (int)(f % g_size);
      row_off[r] = row * HD;
      out_off[r] = row * VD;
      hi[r] = causal ? min(tkp, iq + 1) : tkp;
      lo[r] = has_window ? max(0, iq - window + 1) : 0;
      if (lo[r] >= hi[r]) {  // every key masked: equal weights, as the reference
        all_masked[r] = true;
        lo[r] = 0;
        hi[r] = tkp;
      }
    }
  }
  if (threadIdx.x == 0) {
    band_lo = INT_MAX;
    band_hi = 0;
  }
  __syncthreads();
  if (tq4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (active[r] && lo[r] < hi[r]) {
        atomicMin(&band_lo, lo[r]);
        atomicMax(&band_hi, hi[r]);
      }
  }
  // the warp's band [wlo, whi), the keys every active row of it sees
  // [wfull_lo, wfull_hi), and whether some row is all-masked (warp-uniform)
  int wlo = min(lo[0], lo[1]), whi = max(hi[0], hi[1]);
  int wfull_lo = max(active[0] ? lo[0] : INT_MIN, active[1] ? lo[1] : INT_MIN);
  int wfull_hi = min(active[0] ? hi[0] : INT_MAX, active[1] ? hi[1] : INT_MAX);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o));
    wfull_lo = max(wfull_lo, __shfl_xor_sync(0xffffffffu, wfull_lo, o));
    wfull_hi = min(wfull_hi, __shfl_xor_sync(0xffffffffu, wfull_hi, o));
  }
  const bool warp_all_masked = __any_sync(0xffffffffu, all_masked[0] || all_masked[1]);
  __syncthreads();
  const int blo = band_lo, bhi = band_hi;

  // Q as the A operand: float32 split into TF32 big and small once here,
  // big in registers and small parked in shared memory after the K/V ring
  // (uint4 [warp][kk][lane], read back by the same thread); bfloat16 as
  // packed pairs in registers
  uint4* const qsmall =
      reinterpret_cast<uint4*>(smem_raw + STAGES * KT * (LDK + LDV) * sizeof(T)) + warp_id * KS * 32 +
      lane;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t qs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1;  // a0, a2: row gq; a1, a3: row gq + 8
      if constexpr (F32) {
        const int col = qc0 + 8 * kk + tq4 + 4 * (i >> 1);
        const float x = active[r] ? q[row_off[r] + col] : 0.f;
        split(x, qa[kk][i], qs[i]);
      } else {
        const int col = 16 * kk + 2 * tq4 + 8 * (i >> 1);
        qa[kk][i] = active[r] && col < HDW
                        ? *reinterpret_cast<const uint32_t*>(q + row_off[r] + qc0 + col)
                        : 0u;
      }
    }
    if constexpr (F32) qsmall[kk * 32] = make_uint4(qs[0], qs[1], qs[2], qs[3]);
  }

  float o[DN][4];
#pragma unroll
  for (int d = 0; d < DN; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  // key ik at (kv_row0 + ik*kh)*HD in k and (kv_row0 + ik*kh)*VD in v
  const size_t kv_row0 = (size_t)b * tk * kh + kvh;
  auto stage_k = [&](int s) { return smem + (size_t)s * KT * (LDK + LDV); };
  auto load_tile = [&](int k0, int s) {
    T* ks = stage_k(s);
    T* vs = ks + KT * LDK;
    for (int c = threadIdx.x; c < KT * CPR; c += NTHREADS) {
      const int j = c / CPR, part = c % CPR;
      const int ik = k0 + j;
      const bool real = ik < tk;  // padded keys are zeros
      const size_t row = kv_row0 + (size_t)ik * kh;
      if (CPRK == CPR || part < CPRK)
        cp_async16(ks + j * LDK + part * EPC, k + (real ? row * HD + part * EPC : 0),
                   real ? 16 : 0);
      if (CPRV == CPR || part < CPRV)
        cp_async16(vs + j * LDV + part * EPC, v + (real ? row * VD + part * EPC : 0),
                   real ? 16 : 0);
    }
  };

  const int n_kt = bhi > blo ? (bhi - blo + KT - 1) / KT : 0;
  if (n_kt > 0) load_tile(blo, 0);
  cp_async_commit();
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = blo + it * KT;
    if (it + 1 < n_kt) load_tile(k0 + KT, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait1();  // this tile's copies (all but the newest group) landed
    __syncthreads();
    const T* ks = stage_k(it % STAGES);
    const T* vs = ks + KT * LDK;

    if (k0 < whi && k0 + KT > wlo) {  // warp-uniform: some row sees the tile
      // S = Q K^T for 16 rows x KT keys; s[nt] is keys k0 + 8nt .. + 7
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qs[4];
        if constexpr (F32) {
          const uint4 x = qsmall[kk * 32];
          qs[0] = x.x, qs[1] = x.y, qs[2] = x.z, qs[3] = x.w;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* kr = ks + (8 * nt + gq) * LDK + qc0;
          if constexpr (F32) {
            uint32_t bb0, bs0, bb1, bs1;
            split(kr[8 * kk + tq4], bb0, bs0);
            split(kr[8 * kk + tq4 + 4], bb1, bs1);
            mma_3xtf32(s[nt], qa[kk], qs, bb0, bb1, bs0, bs1);
          } else {
            const int c0 = 16 * kk + 2 * tq4;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + c0);
            const uint32_t b1 = c0 + 8 < HDW ? *reinterpret_cast<const uint32_t*>(kr + c0 + 8) : 0u;
            mma_bf16(s[nt], qa[kk], b0, b1);
          }
        }
      }

      if constexpr (SPLIT > 1) {
        // the pair's partial S (over its halves of q/k's width) summed through
        // shared memory: each warp parks its own (float4 [warp][nt][lane])
        // and adds its partner's, so both hold the same S (a + b == b + a)
        // and take the same m and l; they sync as a pair (named barrier
        // 1 + row group, 64 threads). The ring's __syncthreads below keeps
        // the next tile's writes after these reads.
        float4* const sx = reinterpret_cast<float4*>(
            smem_raw + STAGES * KT * (LDK + LDV) * sizeof(T) +
            (F32 ? WARPS * SPLIT * KS * 32 * 16 : 0));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          sx[(warp_id * NT + nt) * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
        asm volatile("bar.sync %0, %1;" ::"r"(1 + warp), "r"(32 * SPLIT) : "memory");
        const int other = warp + (1 - share) * WARPS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 x = sx[(other * NT + nt) * 32 + lane];
          s[nt][0] += x.x, s[nt][1] += x.y, s[nt][2] += x.z, s[nt][3] += x.w;
        }
      }

      // scale, mask, online softmax; element e of s[nt] is row e >> 1,
      // key k0 + 8nt + 2 tq4 + (e & 1)
      const bool need_mask = warp_all_masked || k0 < wfull_lo || k0 + KT > wfull_hi;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = s[nt][e] * scale;
          if (need_mask) {
            const int ik = k0 + 8 * nt + 2 * tq4 + (e & 1);
            x = ik >= lo[r] && ik < hi[r] ? (all_masked[r] ? 0.f : x) : -INFINITY;
          }
          s[nt][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m[e >> 1]);  // 0 outside the band
          l[e >> 1] += p;
          s[nt][e] = p;
        }
      }
      // O = alpha O + P V, with this tile's P V taken from zero and added in
      // float32 (the tensor cores' own accumulation is coarser than
      // float32's round to nearest, and O runs over every tile)
      if constexpr (fold_pv<T, HDW, VDW>()) {
        static_assert(F32, "the fold is written for the float32 instances");
        // P split once a tile; each 8-column group of P V summed over the
        // tile's keys, then folded into O
        uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          split(s[nt][0], pb[nt][0], ps[nt][0]);
          split(s[nt][2], pb[nt][1], ps[nt][1]);
          split(s[nt][1], pb[nt][2], ps[nt][2]);
          split(s[nt][3], pb[nt][3], ps[nt][3]);
        }
#pragma unroll
        for (int d = 0; d < DN; ++d) {
          float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* vr = vs + (8 * nt + 2 * tq4) * LDV + vc0 + gq + 8 * d;
            uint32_t bb0, bs0, bb1, bs1;
            split(vr[0], bb0, bs0);
            split(vr[LDV], bb1, bs1);
            mma_3xtf32(pv, pb[nt], ps[nt], bb0, bb1, bs0, bs1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[e]);
        }
      } else {
        float pv[DN][4];
#pragma unroll
        for (int d = 0; d < DN; ++d) pv[d][0] = pv[d][1] = pv[d][2] = pv[d][3] = 0.f;
        if constexpr (F32) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // A's column tq4 is key 2 tq4, column tq4 + 4 is key 2 tq4 + 1
            uint32_t pb[4], ps[4];
            split(s[nt][0], pb[0], ps[0]);
            split(s[nt][2], pb[1], ps[1]);
            split(s[nt][1], pb[2], ps[2]);
            split(s[nt][3], pb[3], ps[3]);
            const T* vr = vs + (8 * nt + 2 * tq4) * LDV + vc0 + gq;
#pragma unroll
            for (int d = 0; d < DN; ++d) {
              uint32_t bb0, bs0, bb1, bs1;
              split(vr[8 * d], bb0, bs0);
              split(vr[8 * d + LDV], bb1, bs1);
              mma_3xtf32(pv[d], pb, ps, bb0, bb1, bs0, bs1);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {  // 16 keys a k-step
            const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                    pack_bf16(s[2 * j][2], s[2 * j][3]),
                                    pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                    pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
            const T* vr = vs + (16 * j + 2 * tq4) * LDV + vc0 + gq;
#pragma unroll
            for (int d = 0; d < DN; ++d) {
              const T* x = vr + 8 * d;
              mma_bf16(pv[d], pa, pack_bf16(x[0], x[LDV]), pack_bf16(x[8 * LDV], x[9 * LDV]));
            }
          }
        }
#pragma unroll
        for (int d = 0; d < DN; ++d) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[d][e]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (active[r]) {
#pragma unroll
      for (int d = 0; d < DN; ++d)
        put2(out + out_off[r] + vc0 + 8 * d + 2 * tq4, o[d][2 * r] / den, o[d][2 * r + 1] / den);
    }
  }
}

template <typename T, int HD, int VD = HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out, int b,
                      int tq, int tk, int tkp, int h, int kh, float scale, int causal,
                      int has_window, int window, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD, VD>;
  static_assert(key_tile<T, HD, VD>() > 0, "no key tile of 16 or more fits the shared memory");
  constexpr int bytes = smem_bytes<T, HD, VD>();
  static_assert(bytes <= smem_budget<T, HD, VD>(), "shared memory past blocks_per_sm()'s share");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)tq * (h / kh);
  const dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), kh, b);
  kernel<<<grid, THREADS * width_split<T, HD, VD>(), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), tq, tk, tkp, h, kh, scale, causal, has_window, window);
  return cudaGetLastError();
}

template <int HD, int VD>
struct Widths {
  static constexpr int hd = HD, vd = VD;
};

// f(Widths<hd, vd>{}) for an instantiated width pair, else
// cudaErrorInvalidValue
template <typename F>
cudaError_t by_widths(int hd, int vd, F&& f) {
  if (hd == 192 && vd == 128) return f(Widths<192, 128>{});
  if (vd != hd) return cudaErrorInvalidValue;
  switch (hd) {
    case 8: return f(Widths<8, 8>{});
    case 16: return f(Widths<16, 16>{});
    case 32: return f(Widths<32, 32>{});
    case 64: return f(Widths<64, 64>{});
    case 128: return f(Widths<128, 128>{});
    case 256: return f(Widths<256, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out,
                         int b, int tq, int tk, int tkp, int h, int kh, int hd,
                         int vd, float scale, int causal, int has_window, int window,
                         cudaStream_t stream) {
  return by_widths(hd, vd, [&](auto w) {
    return launch_hd<T, decltype(w)::hd, decltype(w)::vd>(
        q, k, v, out, b, tq, tk, tkp, h, kh, scale, causal, has_window, window, stream);
  });
}

// the design of one instance (see flash_attention_plan)
template <typename T>
cudaError_t plan_typed(int hd, int vd, int* plan) {
  return by_widths(hd, vd, [&](auto w) {
    constexpr int HD = decltype(w)::hd, VD = decltype(w)::vd;
    auto kernel = flash_attention_kernel<T, HD, VD>;
    constexpr int bytes = smem_bytes<T, HD, VD>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    plan[0] = key_tile<T, HD, VD>();
    plan[1] = bytes;
    plan[2] = THREADS * width_split<T, HD, VD>();
    plan[3] = blocks_per_sm<T, HD, VD>();
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[4], kernel, plan[2], bytes);
  });
}

}  // namespace

// Launch on `stream`; no synchronise, no allocation. hd is q's and k's
// width, vd v's and the output's. dtype 0 is float32, 1 bfloat16. Every
// pointer must be 16-byte aligned (cp.async, paired stores). Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// width pair that is not instantiated).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int b, int tq, int tk, int tkp,
                                      int h, int kh, int hd, int vd, int dtype, float scale,
                                      int causal, int has_window, int window,
                                      void* stream) {
  if (b < 1 || b > 65535 || tq < 1 || tk < 0 || tkp < tk || kh < 1 || kh > 65535 ||
      h < kh || h % kh != 0 || h / kh > MAX_GROUP || (has_window && window < 1))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(q, k, v, out, b, tq, tk, tkp, h, kh, hd, vd, scale,
                                    causal, has_window, window, s);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, out, b, tq, tk, tkp, h, kh, hd, vd,
                                            scale, causal, has_window, window, s);
  return (int)cudaErrorInvalidValue;
}

// The design of the (hd, vd) instance for dtype (0 float32, 1 bfloat16), in
// plan[0..4]: keys per shared-memory tile, dynamic shared memory bytes a
// block, threads a block, the blocks an SM it is built for, and the blocks
// an SM the runtime grants it (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the query's cudaError_t (cudaErrorInvalidValue for a pair that is
// not instantiated).
extern "C" int flash_attention_plan(int hd, int vd, int dtype, int* plan) {
  if (dtype == 0) return (int)plan_typed<float>(hd, vd, plan);
  if (dtype == 1) return (int)plan_typed<__nv_bfloat16>(hd, vd, plan);
  return (int)cudaErrorInvalidValue;
}
