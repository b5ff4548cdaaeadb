#!/usr/bin/env python3
"""Kernel B4's widest float32 instances against variants of their design.

    python3 tools/b4_hd128_variants.py [--against OTHER.cu] [--shapes hd128,mla,rg]

First the registers, stack and spills ``ptxas -v`` reports for every
instance of the committed source, with the tile, shared memory and blocks
an SM each instance is built for and the runtime grants it
(``kernel_plan``), and with ``--against`` whether each instance the other
source also has (an earlier revision of ``flash_attention.cu``) gets the
same report.

Three shapes, causal, float32 (``--shapes`` picks some). At Phi-4-mini's
prefill (4, 2016, 24, 8, 128):
the source as committed (32-key tiles, two blocks an SM; a whole tile of
P V in registers), a copy with 64-key tiles (one block an SM), and a copy
that folds each 8-column group of P V into O as soon as it is summed over
the tile's keys (``fold``: 4 registers instead of 64; the same sums in the
same order). At MLA's prefill in DeepSeek-V3, (2, 2016, 128, 128) with q/k
width 192 and v width 128: the source as committed (the fold, 16-key
tiles, two blocks an SM), a copy with 32-key tiles (one block an SM), a
copy without the fold (a whole tile of P V in registers), and a copy that
parks Q's TF32 big half in shared memory beside its small half, without
the fold (``qbig``: 96 registers fewer; 140 KB of shared memory, one block
an SM). At RecurrentGemma's local attention in a 2 x 4096 forward, (2,
4096, 10, 1, 256) with window 2048: the source as committed (the width
split across a pair of warps, 32-key tiles, one block of 8 warps an SM), a
copy with 16-key tiles (``kt16``), a copy that parks Q's big half in shared
memory beside its small half with one warp on each row group and the fold
(``qbig``: 16-key tiles, one block of 4 warps an SM), and a copy that
computes O in two launches, one for each half of v's columns, each
recomputing S over the whole width (``twopass``: a (256, 128) instance
reading v and writing the output at a row stride of 256, with the fold,
16-key tiles, two blocks an SM). The copies are written into
``build/repro_torch/`` and built like
the kernel (``ptxas -v`` prints their registers and spills). Each is held
to the plain twin, then the variants of a shape are timed with CUDA events
in turns (four rounds of 10 launches). Needs a CUDA card.
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, build_library  # noqa: E402


def ptxas_report(source: Path) -> dict:
    """{(type, hd, vd): (registers, stack, spill stores, spill loads)} as
    ``ptxas -v`` reports each instance of ``source``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run([nvcc, *NVCC_FLAGS, "-o", f"{tmp}/lib.so", str(source)],
                             capture_output=True, text=True, check=True)
    report, inst, frame = {}, None, None
    for line in run.stderr.splitlines():
        m = re.search(r"flash_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E(?:Li(\d+)E)?E", line)
        if "Compiling entry function" in line and m:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            inst = (dtype, int(m.group(2)), int(m.group(3) or m.group(2)))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill", line)
        if m:
            frame = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m and inst:
            report[inst] = (int(m.group(1)),) + frame
            inst = None
    return report


ap = argparse.ArgumentParser()
ap.add_argument("--against", type=Path, help="another revision of flash_attention.cu")
ap.add_argument("--shapes", default="hd128,mla,rg", help="the shapes to time, comma-separated")
args = ap.parse_args()
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
ours = ptxas_report(fa.SOURCE)
theirs = ptxas_report(args.against) if args.against else {}
for inst, rep in sorted(ours.items()):
    note = "" if inst not in theirs else (
        "; the same in the other source" if theirs[inst] == rep
        else f"; DIFFERS from the other source's {theirs[inst]}")
    plan = fa.kernel_plan(inst[1], inst[2], getattr(torch, inst[0]))
    print(f"{inst}: {rep[0]} registers, {rep[1]} bytes stack, {rep[2]} / {rep[3]} bytes "
          f"spill stores / loads{note}; {plan['key_tile']}-key tiles, {plan['smem_bytes']} bytes "
          f"of shared memory and {plan['threads']} threads a block, built for "
          f"{plan['blocks_per_sm']} blocks an SM, granted {plan['granted_blocks_per_sm']}",
          flush=True)


def variant(src: str, *edits: tuple[str, str]) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"not once in the source: {old!r}")
        src = src.replace(old, new)
    return src


src = fa.SOURCE.read_text()
KEY_TILE = ("  return smem_bytes_at<T, HD, VD>(64) <= smem_budget<T, HD, VD>()   ? 64",
            "  return true ? 64")
FOLD_AT = "  return (std::is_same<T, float>::value ? HD / 2 : (HD + 15) / 16 * 4) + VD > 192;"
SPLIT_AT = "__host__ __device__ constexpr int width_split() { return HD + VD > 384 ? 2 : 1; }"
BLOCKS_AT = ("__host__ __device__ constexpr int blocks_per_sm() "
             "{ return 2 / width_split<T, HD, VD>(); }")
QBIG = [  # Q big beside Q small in shared memory, read back each k-step; one block an SM
    ("(std::is_same<T, float>::value ? WARPS * (HD / 8) * 32 * 16 : 0) +  // Q small",
     "(std::is_same<T, float>::value ? 2 * WARPS * (HD / 8) * 32 * 16 : 0) +  // Q small"),
    (BLOCKS_AT, BLOCKS_AT.replace(
        "return 2", "return std::is_same<T, float>::value && HD >= 192 ? 1 : 2")),
    ("    if constexpr (F32) qsmall[kk * 32] = make_uint4(qs[0], qs[1], qs[2], qs[3]);",
     "    if constexpr (F32) qsmall[kk * 32] = make_uint4(qs[0], qs[1], qs[2], qs[3]);\n"
     "    if constexpr (F32) qsmall[(WARPS * KS + kk) * 32] = "
     "make_uint4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);"),
    ("          const uint4 x = qsmall[kk * 32];",
     "          const uint4 x = qsmall[kk * 32];\n"
     "          const uint4 y = qsmall[(WARPS * KS + kk) * 32];\n"
     "          qb[0] = y.x, qb[1] = y.y, qb[2] = y.z, qb[3] = y.w;"),
    ("        uint32_t qs[4];\n        if constexpr (F32) {",
     "        uint32_t qs[4], qb[4];\n        if constexpr (F32) {"),
    ("            mma_3xtf32(s[nt], qa[kk], qs, bb0, bb1, bs0, bs1);",
     "            mma_3xtf32(s[nt], qb, qs, bb0, bb1, bs0, bs1);"),
]
VARIANTS = {
    "hd128": {"kt64": [KEY_TILE], "fold": [(FOLD_AT, FOLD_AT.replace("> 192", "> 191"))]},
    "mla": {"kt32": [("         : smem_bytes_at<T, HD, VD>(16) <= smem_budget<T, HD, VD>() ? 16",
                      "         : true ? 32")],
            "nofold": [(FOLD_AT, FOLD_AT.replace("> 192", "> 1000"))],
            "qbig": QBIG + [(FOLD_AT, FOLD_AT.replace("> 192", "> 1000"))]},
    "rg": {"kt16": [(KEY_TILE[0], "  return width_split<T, HD, VD>() > 1 ? 16\n"
                                  "         : smem_bytes_at<T, HD, VD>(64) <= "
                                  "smem_budget<T, HD, VD>() ? 64")],
           "qbig": QBIG + [(SPLIT_AT, SPLIT_AT.replace(
               "> 384", "> (std::is_same<T, float>::value ? 1000 : 384)"))],
           "twopass": [  # a (256, 128) instance over v's halves, strides of 256
               ("  if (hd == 192 && vd == 128) return f(Widths<192, 128>{});",
                "  if (hd == 192 && vd == 128) return f(Widths<192, 128>{});\n"
                "  if (hd == 256 && vd == 128) return f(Widths<256, 128>{});"),
               ("      out_off[r] = row * VD;", "      out_off[r] = row * HD;"),
               ("v + (real ? row * VD + part * EPC : 0)",
                "v + (real ? row * HD + part * EPC : 0)")]},
}
# (B, T, H, KH, hd, vd, window)
SHAPES = {"hd128": (4, 2016, 24, 8, 128, 128, None), "mla": (2, 2016, 128, 128, 192, 128, None),
          "rg": (2, 4096, 10, 1, 256, 256, 2048)}

BUILD_DIR.mkdir(parents=True, exist_ok=True)
committed = fa.load_library()
dev = torch.device("cuda")
for shape_name in args.shapes.split(","):
    b, t, h, kh, hd, vd, window = SHAPES[shape_name]
    libs = {"committed": committed}
    for name, edits in VARIANTS[shape_name].items():
        path = BUILD_DIR / f"fa_variant_{shape_name}_{name}.cu"
        path.write_text(variant(src, *edits))
        print(f"--- building {shape_name} {name}", flush=True)
        lib = build_library(path)
        lib.flash_attention_launch.argtypes = committed.flash_attention_launch.argtypes
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, t, h, hd, generator=gen, device=dev)
    k = torch.randn(b, t, kh, hd, generator=gen, device=dev)
    v = torch.randn(b, t, kh, vd, generator=gen, device=dev)
    scale = hd ** -0.5
    want = fa.flash_attention_plain(q, k, v, scale=scale, window=window, q_blk=1024, k_blk=2048)
    out = torch.empty((b, t, h, vd), device=dev)

    def launch(lib, name):
        halves = [(0, vd)] if name != "twopass" else [(0, vd // 2), (vd // 2, vd // 2)]
        for col, width in halves:  # twopass: one launch for each half of v's columns
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr() + 4 * col, out.data_ptr() + 4 * col,
                b, t, t, t, h, kh, hd, width, 0, scale, 1, int(window is not None), window or 0,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

    times = {name: [] for name in libs}
    for name, lib in libs.items():
        out.fill_(float("nan"))
        launch(lib, name)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        print(f"{shape_name} {name}: max_abs_err {err:.3g}", flush=True)
        if not err <= 2e-5:
            raise RuntimeError(f"{name} differs from the plain twin by {err}")
    del want
    for rnd in range(4):
        for name, lib in libs.items():
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(10):
                launch(lib, name)
            e.record()
            torch.cuda.synchronize()
            times[name].append(s.elapsed_time(e) / 10)
    for name, ts in times.items():
        print(f"{shape_name} {(b, t, h, kh, hd, vd)} window {window} {name}: "
              + ", ".join(f"{x:.4f}" for x in ts) + " ms", flush=True)
    del q, k, v, out
