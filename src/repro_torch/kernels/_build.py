"""Build a kernel source with nvcc at first use and load it with ctypes.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled for
``sm_90a`` into ``build/repro_torch/<stem>_<hash>.so``, keyed by a hash of
the source, so an edited source is rebuilt and an unchanged one is not.
``ptxas -v`` prints each kernel's registers, spills and shared memory as
it builds.
Nothing is built when a module is imported: the kernel wrappers call this
on their first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per source hash) and load the library."""
    src = source.read_bytes()
    lib_path = BUILD_DIR / f"{source.stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not Path(nvcc).exists():
            raise RuntimeError(
                f"nvcc not found on PATH or in /usr/local/cuda/bin: {source.name} "
                "is built from source at first use"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)], check=True)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
