"""Build the port's host library: python -m stem_kernel_torch.native.build.

``native/smo.cpp`` and ``native/dagscan.cpp`` are compiled by g++ with the
flags of ``stem_kernel_tpu/native/build.py`` (so that on one machine both
libraries compute the same bits) into one shared library with a plain C
interface, ``build/stem_kernel_torch/libsktnative_torch.so`` at the root of
the checkout (listed in ``.gitignore``).  It is built at its first use in a
process, and again when a source is newer than it.  Nothing here runs at
import.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "stem_kernel_torch"
LIB_NAME = "libsktnative_torch.so"
SOURCES = ("smo.cpp", "dagscan.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def build(force: bool = False) -> Path:
    """Compile the library if it is missing or older than a source; its path.

    Raises RuntimeError when g++ is not on PATH or the build fails.
    """
    lib = BUILD_DIR / LIB_NAME
    srcs = [NATIVE_DIR / s for s in SOURCES]
    if (not force and lib.exists()
            and lib.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)):
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: stem_kernel_torch builds its host "
                           "library (native/smo.cpp, native/dagscan.cpp) at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_lib, *map(str, srcs)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_lib, lib)
    return lib


if __name__ == "__main__":
    print(build(force=True))
