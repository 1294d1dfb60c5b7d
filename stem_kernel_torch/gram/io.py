"""LIBSVM PRECOMPUTED-format Gram matrix I/O.

Format (KernelMatrix::print, stem_kernel/common/kernel_matrix.cpp:756-770):

    <label> 0:<row-index-1-based> 1:<K(i,1)> 2:<K(i,2)> ... N:<K(i,N)>

Writers transparently gzip/bzip2-compress by filename suffix, like the
reference's boost::iostreams output chain
(stem_kernel/common/framework.h:142-148).  The norm file (one k(x,x) per
test example, framework.cpp:223-234) feeds offline normalization.
"""

from __future__ import annotations

import bz2
import gzip
import io
from typing import IO, Iterable

import numpy as np


def _open_write(path: str) -> IO[str]:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "wb"))
    if path.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(path, "wb"))
    return open(path, "w")


def _open_read(path: str) -> IO[str]:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    if path.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(path, "rb"))
    return open(path)


def format_row(label: str, index: int, values: Iterable[float]) -> str:
    cells = " ".join(f"{j + 1}:{v:.15g}" for j, v in enumerate(values))
    return f"{label} 0:{index} {cells} "


def write_precomputed(path: str, labels: list[str], matrix: np.ndarray) -> None:
    """Write a full Gram matrix in LIBSVM PRECOMPUTED format."""
    with _open_write(path) as f:
        for i, (label, row) in enumerate(zip(labels, matrix)):
            f.write(format_row(label, i + 1, row))
            f.write("\n")


def write_rows(path_or_file, labels: list[str], rows: np.ndarray, start_index: int = 1) -> None:
    """Append kernel rows (test-vs-train) in the same format."""
    f = _open_write(path_or_file) if isinstance(path_or_file, str) else path_or_file
    try:
        for t, (label, row) in enumerate(zip(labels, rows)):
            f.write(format_row(label, start_index + t, row))
            f.write("\n")
    finally:
        if isinstance(path_or_file, str):
            f.close()


def write_norm(path: str, self_values: np.ndarray) -> None:
    """Write k(x,x) per example, one per line (framework.cpp:223-234)."""
    with _open_write(path) as f:
        for v in self_values:
            f.write(f"{v:.15g}\n")


def read_precomputed(path: str) -> tuple[list[str], np.ndarray]:
    """Read a PRECOMPUTED-format matrix back: (labels, matrix).

    Accepts the output of :func:`write_precomputed` or of the reference
    binaries (feature ids must be 0,1,...,N in order).
    """
    labels: list[str] = []
    rows: list[np.ndarray] = []
    with _open_read(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(parts[0])
            vals = []
            for cell in parts[1:]:
                idx, v = cell.split(":")
                if idx == "0":
                    continue
                vals.append(float(v))
            rows.append(np.asarray(vals, dtype=np.float64))
    return labels, np.vstack(rows) if rows else np.zeros((0, 0))
