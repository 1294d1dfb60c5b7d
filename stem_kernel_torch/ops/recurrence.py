"""First-order linear recurrence along the last axis, for a constant weight.

Port of ``stem_kernel_tpu/ops/recurrence.py:linear_recurrence``.  Torch has
no associative scan, and the closed form ``a^t * cumsum(b * a^-t)``
overflows f32 once the axis passes a few hundred elements at a = 0.8.  For a
constant ``a`` the recurrence is a product with an upper-triangular
Toeplitz matrix

    x = b @ T,    T[s, t] = a^(t - s) for t >= s, 0 below,

whose entries are all <= 1 for |a| <= 1: exact, and no overflow at any
length.  The log-semiring and max-plus recurrences belong to later slices.
"""

from __future__ import annotations

import torch


def toeplitz_powers(a: float, n: int, *, device, dtype=torch.float32,
                    reverse: bool = False) -> torch.Tensor:
    """(n, n) T with T[s, t] = a^(t-s) for t >= s (t <= s when ``reverse``)."""
    idx = torch.arange(n, device=device, dtype=torch.float64)
    lag = idx[None, :] - idx[:, None]
    if reverse:
        lag = -lag
    t = torch.where(lag >= 0, torch.as_tensor(float(a), dtype=torch.float64,
                                              device=device) ** lag.clamp(min=0),
                    torch.zeros((), dtype=torch.float64, device=device))
    return t.to(dtype)


def linear_recurrence(a: float, b: torch.Tensor, *, reverse: bool = False,
                      matrix: torch.Tensor | None = None) -> torch.Tensor:
    """Solve x[t] = a * x[t-1] + b[t] with x[-1] = 0, along the last axis.

    Element t equals sum_{s<=t} b[s] * a^(t-s).  ``a`` is a Python scalar;
    ``matrix`` optionally passes a precomputed :func:`toeplitz_powers`
    (row loops reuse one).  ``reverse`` runs the recurrence from the end.
    """
    n = b.shape[-1]
    if matrix is None:
        matrix = toeplitz_powers(a, n, dtype=b.dtype, device=b.device, reverse=reverse)
    # one (1, n) @ (n, n) product per row: a folded (rows, n) @ (n, n) GEMM
    # blocks by the row count, so a row's value would depend on how many
    # rows share the call (the Gram must not change with its batch size)
    rows = b.reshape(-1, 1, n)
    return torch.bmm(rows, matrix.expand(rows.shape[0], n, n)).reshape(b.shape)
