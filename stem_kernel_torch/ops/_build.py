"""Build and load the port's CUDA library from ``stem_kernel_torch/csrc``.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a``, one nvcc process
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes.  The library
goes to ``build/stem_kernel_torch/`` at the root of the checkout (listed in
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
PTXAS_LOG = "ptxas.txt"  # each kernel's registers, shared memory and spills, from the last build
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math / -ftz: the kernels keep subnormals, as torch does on the CPU
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    # build in a private directory, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        failed, log = [], []
        for s, proc in zip(srcs, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{s.name} ({proc.returncode}):\n{out}\n{err}")
            log.append(f"== {s.name}\n{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        (BUILD_DIR / PTXAS_LOG).write_text("".join(log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with argtypes declared for every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (ns, vx, vy, ax, ay, l, ux, uy, iters, batch, nx, ny, mode, rt, sn,
    #  csize, stages, spill, lag, cvx, cax, cvy, cay, mc, g2c, mf, st, out,
    #  stream)
    fn = lib.stem_fixed_point_tiles
    fn.argtypes = [p] * 9 + [i] * 10 + [p] * 10
    fn.restype = ctypes.c_int
    fn = lib.stem_fixed_point_tiles_info
    fn.argtypes = [i] * 8 + [p]
    fn.restype = ctypes.c_int
    # (ns, vx, vy, ax, ay, l, ux, uy, iters, batch, nx, ny, mode, out, stream)
    fn = lib.stem_fixed_point_cluster
    fn.argtypes = [p] * 9 + [i, i, i, i] + [p, p]
    fn.restype = ctypes.c_int
    fn = lib.stem_fixed_point_cluster_info
    fn.argtypes = [i, i, i, p]
    fn.restype = ctypes.c_int
    # (p0, p1, lx, ly, batch, max_lx, max_ly[, rank], lanes, cols, alpha,
    #  beta, bg, be, log bg, log be, out, stream)
    for name, n_int in (("la_log_factored_f32", 6), ("la_exp_factored_f32", 6),
                        ("la_exp_f32", 5), ("la_log_f32", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 4 + [i] * n_int + [f] * 6 + [p, p]
        fn.restype = ctypes.c_int
    # (x, y, bp_x, bp_y, lx, ly, a, k0, g0, k1, g1, scale, log_scale, out,
    #  batch, n, band, max_lx, gap, stack, subst, stream)
    fn = lib.full_stem_banded_f32
    fn.argtypes = [p] * 14 + [i] * 4 + [f] * 3 + [p]
    fn.restype = ctypes.c_int
    # (x, n, m, out, stream)
    fn = lib.full_stem_div_scale_f32
    fn.argtypes = [p, i, f, p, p]
    fn.restype = ctypes.c_int
    # (px, py, subst, wx, wy, lx, ly, batch, max_lx, max_ly, gap, out, stream)
    fn = lib.string_dp_profile_f32
    fn.argtypes = [p] * 7 + [i] * 3 + [f, p, p]
    fn.restype = ctypes.c_int
    # (scores, batch, max_lx, max_ly, gap, out, stream)
    fn = lib.string_dp_scores_f32
    fn.argtypes = [p] + [i] * 3 + [f, p, p]
    fn.restype = ctypes.c_int
    # (tabs, expl_ds, expl_sh, n_expl, ncls, cdim, n_off, off_w, off_meta,
    #  cpow, c_lin, c_ext, lengths, batch, n, scratch, bpp, logz, stream)
    fn = lib.fold_dp_f32
    fn.argtypes = [p] * 3 + [i] * 4 + [p] * 3 + [f, f, p, i, i] + [p] * 4
    fn.restype = ctypes.c_int
    # (batch, n, ncls, cdim, n_off)
    fn = lib.fold_dp_scratch_floats
    fn.argtypes = [i] * 5
    fn.restype = ctypes.c_longlong
    # (n, ncls, cdim, n_off, bytes)
    fn = lib.fold_dp_route
    fn.argtypes = [i] * 4 + [p]
    fn.restype = ctypes.c_int
    return lib
