"""Build and load the port's CUDA library from ``stem_kernel_torch/csrc``.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes.  The library goes to
``build/stem_kernel_torch/`` at the root of the checkout (listed in
``.gitignore``).  It is built at its first use in a process, and built
again when any source is newer than it.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "stem_kernel_torch"
LIB_NAME = "libstem_kernel_torch.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def find_nvcc() -> str:
    """nvcc on PATH or under /usr/local/cuda; raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of stem_kernel_torch are built from source at first use")
    return nvcc


def sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build() -> tuple[Path, float]:
    """Compile the library if it is missing or older than a source.

    Returns (path, seconds spent compiling; 0.0 when it was up to date).
    """
    lib = BUILD_DIR / LIB_NAME
    srcs = sources()
    if lib.exists() and lib.stat().st_mtime >= max(s.stat().st_mtime for s in srcs):
        return lib, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with argtypes declared for every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.stem_fixed_point_f32
    fn.argtypes = [p] * 9 + [i, i, i, i] + [p] * 4 + [p]
    fn.restype = ctypes.c_int
    return lib
