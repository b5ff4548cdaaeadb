#!/usr/bin/env python3
"""Kernel B4's hd = 128 float32 instance against two variants of its design.

    python3 tools/b4_hd128_variants.py

At Phi-4-mini's prefill (4, 2016, 24, 8, 128), causal: the source as
committed (32-key tiles, two blocks an SM; a whole tile of P V in
registers), a copy with 64-key tiles (one block an SM), and a copy that
folds each 8-column group of P V into O as soon as it is summed over the
tile's keys (``FOLD``: 4 registers instead of 64; the same sums in the
same order). The copies are written into ``build/repro_torch/`` and built
like the kernel (``ptxas -v`` prints their registers and spills). Each is
held to the plain twin, then all are timed with CUDA events in turns
(committed, 64-key, fold; four rounds of 10 launches). Needs a CUDA card.
"""
import ctypes
import subprocess
import sys
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import BUILD_DIR, build_library  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
# the fold, for hd >= 128: P converted once a tile, then each 8-column group
# of P V summed over the tile's keys and folded into O at once
FOLD = r"""
      if constexpr (HD >= 128) {
        if constexpr (F32) {
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
              const T* vr = vs + (8 * nt + 2 * tq4) * LD + gq + 8 * d;
              uint32_t bb0, bs0, bb1, bs1;
              split(vr[0], bb0, bs0);
              split(vr[LD], bb1, bs1);
              mma_3xtf32(pv, pb[nt], ps[nt], bb0, bb1, bs0, bs1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[e]);
          }
        } else {
          uint32_t pa[NT / 2][4];
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
            pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
            pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
            pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
          }
#pragma unroll
          for (int d = 0; d < DN; ++d) {
            float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              const T* x = vs + (16 * j + 2 * tq4) * LD + gq + 8 * d;
              mma_bf16(pv, pa[j], pack_bf16(x[0], x[LD]), pack_bf16(x[8 * LD], x[9 * LD]));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[e]);
          }
        }
      } else {
"""


def variant(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"not in the source: {old!r}")
    return src.replace(old, new, 1)


src = fa.SOURCE.read_text()
kt64 = variant(src, "return std::is_same<T, float>::value && HD >= 128 ? 32 : 64;",
               "return 64;")
# the fold for hd >= 128, the whole-tile P V (through its fold into O) else
pv_start = "      float pv[DN][4];\n"
tile_end = "    }\n    __syncthreads();  // every warp is done"
fold = variant(variant(src, pv_start, FOLD + pv_start), tile_end, "    }\n" + tile_end)
BUILD_DIR.mkdir(parents=True, exist_ok=True)
libs = {"committed": fa.load_library()}
for name, text in (("kt64", kt64), ("fold", fold)):
    path = BUILD_DIR / f"fa_variant_{name}.cu"
    path.write_text(text)
    print(f"--- building {name}", flush=True)
    lib = build_library(path)
    lib.flash_attention_launch.argtypes = libs["committed"].flash_attention_launch.argtypes
    lib.flash_attention_launch.restype = ctypes.c_int
    libs[name] = lib

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
b, t, h, kh, hd = 4, 2016, 24, 8, 128
q = torch.randn(b, t, h, hd, generator=gen, device=dev)
k = torch.randn(b, t, kh, hd, generator=gen, device=dev)
v = torch.randn(b, t, kh, hd, generator=gen, device=dev)
scale = hd ** -0.5
want = fa.flash_attention_plain(q, k, v, scale=scale, q_blk=1024, k_blk=2048)
out = torch.empty_like(q)

def launch(lib):
    err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b, t, t, t, h, kh, hd, 0, scale, 1, 0, 0,
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError_t {err}")

times = {name: [] for name in libs}
for name, lib in libs.items():
    launch(lib)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    print(f"{name}: max_abs_err {err:.3g}", flush=True)
    if not err <= 2e-5:
        raise RuntimeError(f"{name} differs from the plain twin by {err}")
for rnd in range(4):
    for name, lib in libs.items():
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(10):
            launch(lib)
        e.record()
        torch.cuda.synchronize()
        times[name].append(s.elapsed_time(e) / 10)
for name, ts in times.items():
    print(f"{name}: " + ", ".join(f"{x:.4f}" for x in ts) + " ms")
