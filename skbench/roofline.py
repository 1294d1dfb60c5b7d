"""Published peaks of one NVIDIA H100 and the least time K1 and K6 need.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``k1_bound``, ``k6_bound``
and its table of peaks (NVIDIA's data sheet, H100 SXM, dense, 700 W).
Unlike those, the work is counted from what the inputs need, never from
padded shapes: K1 from each pair's unpadded DAG node counts and trips, K6
from each pair's sequence lengths.  So no change of padding or bucketing in
the program moves a roofline share.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_F32 = 67e12  # f32 outside the tensor cores, operations/s
PEAK_TF32 = 495e12  # TF32 tensor cores
PEAK_BF16 = 989e12  # bf16 tensor cores
# --precision name -> (the product unit's peak, passes an operation takes on it)
K1_PEAKS = {"highest": (PEAK_F32, 1), "high": (PEAK_TF32, 3), "default": (PEAK_BF16, 1)}
K6_OPS = 23  # operations a cell of K6: injection 6, window scans 6, re-anchor and combine 10, max 1


def least_seconds(nbytes: float, ops_seconds: float) -> float:
    """The least time: moving ``nbytes`` once, or the work's time on its
    units, whichever is longer."""
    return max(nbytes / PEAK_BYTES, ops_seconds)


def k1_seconds(nx: np.ndarray, ny: np.ndarray, trips: np.ndarray, precision: str) -> float:
    """Least time of K1 over the pairs (nx[p], ny[p]) of unpadded node
    counts, each for trips[p] trips of the fixed point: per trip four
    products, M Vy^T, Vx (.), G Ay^T and Ax (.), 4 nx ny (nx + ny)
    operations on the unit ``precision`` names (3xTF32 as three TF32
    passes), and 2 nx ny elementwise (+ L, * NS) on the f32 units; then the
    bilinear form ux^T M uy, 2 nx ny.  Bytes: the operands NS, L (nx ny),
    Vx, Ax (nx^2), Vy, Ay (ny^2), ux, uy, the trips and the value, once."""
    nx, ny, trips = (np.asarray(v, np.float64) for v in (nx, ny, trips))
    peak, passes = K1_PEAKS[precision]
    products = float((trips * 4.0 * nx * ny * (nx + ny)).sum()) * passes
    elementwise = float((trips * 2.0 * nx * ny + 2.0 * nx * ny).sum())
    nbytes = float((4.0 * (2 * nx * ny + 2 * nx * nx + 2 * ny * ny + nx + ny + 2)).sum())
    return least_seconds(nbytes, products / peak + elementwise / PEAK_F32)


def k6_seconds(lx: np.ndarray, ly: np.ndarray, band: int) -> float:
    """Least time of K6 over the pairs (lx[p], ly[p]) of sequence lengths:
    L = max(lx, ly) levels, level d holding L - d + 1 windows of (2 band +
    1)^2 cells, K6_OPS operations a cell on the f32 units; bytes: the codes
    (one byte a base), the pair weights (4 bytes a cell of each side's
    L x L matrix), the lengths and the value, once."""
    lx, ly = np.asarray(lx, np.float64), np.asarray(ly, np.float64)
    big = np.maximum(lx, ly)
    cells = float((big * (big + 1) / 2).sum()) * (2 * band + 1) ** 2
    nbytes = float((lx + ly + 4.0 * (lx * lx + ly * ly) + 12.0).sum())
    return least_seconds(nbytes, cells * K6_OPS / PEAK_F32)
