"""The least time K2 needs, against the peaks of ``roofline.py``.

A frozen copy of ``chip_smoke.py:la_bound`` for K2 (``la_log_factored``),
with the work counted from what the inputs need, never from padded
shapes: lx * ly cells a pair of the unpadded sequence lengths, each a cell
of the log-space closure (``LA_LOG_OPS``) plus its emission from the rank-K
factors (2K), on the f32 units; bytes: each side's factors (4 K bytes a
position), the two lengths and the value, once a pair.  So no change of
padding or batching in the program moves the share.
"""

from __future__ import annotations

import numpy as np

from .roofline import PEAK_F32, least_seconds

LA_LOG_OPS = 30  # three logaddexp, the row max, exp(m - r), the closure, log
K2_RANK = 6  # factor slots of the BPLA score: two pair slots and the four bases


def k2_seconds(lx: np.ndarray, ly: np.ndarray) -> float:
    """Least time of K2 over the pairs (lx[p], ly[p]) of sequence lengths."""
    lx, ly = np.asarray(lx, np.float64), np.asarray(ly, np.float64)
    cells = float((lx * ly).sum())
    nbytes = float((4.0 * K2_RANK * (lx + ly) + 12.0).sum())
    return least_seconds(nbytes, cells * (LA_LOG_OPS + 2 * K2_RANK) / PEAK_F32)
