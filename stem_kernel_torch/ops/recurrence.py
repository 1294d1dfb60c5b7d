"""First-order semiring recurrences along the last axis, for a constant weight.

Port of ``stem_kernel_tpu/ops/recurrence.py``.  Torch has no associative
scan, so each recurrence takes a closed form that is exact for a constant
weight ``a``:

- sum-product, ``linear_recurrence``.  The closed form
  ``a^t * cumsum(b * a^-t)`` overflows f32 once the axis passes a few
  hundred elements at a = 0.8, so the recurrence is a product with an
  upper-triangular Toeplitz matrix

      x = b @ T,    T[s, t] = a^(t - s) for t >= s, 0 below,

  whose entries are all <= 1 for |a| <= 1: exact, and no overflow at any
  length;
- log-semiring, ``logsumexp_recurrence``:
  ``x[t] = a*t + logcumsumexp_s(b[s] - a*s)``;
- max-plus, ``maxplus_recurrence``: ``x[t] = a*t + cummax_s(b[s] - a*s)``.

In log space the shift ``a*s`` is additive and stays small (|a| * length),
so the last two need no matrix.
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


def _ramp(a: float, b: torch.Tensor, reverse: bool) -> torch.Tensor:
    """a * t along the last axis (t counted from the end when ``reverse``)."""
    t = torch.arange(b.shape[-1], device=b.device, dtype=b.dtype)
    return float(a) * (t.flip(0) if reverse else t)


def logsumexp_recurrence(a: float, b: torch.Tensor, *,
                         reverse: bool = False) -> torch.Tensor:
    """Solve x[t] = logaddexp(x[t-1] + a, b[t]) with x[-1] = -inf.

    Element t equals logsumexp_{s<=t} (b[s] + a*(t-s)), computed as
    ``a*t + logcumsumexp(b - a*t)``.  ``a`` is a Python scalar.
    """
    ramp = _ramp(a, b, reverse)
    if reverse:
        return ramp + torch.logcumsumexp((b - ramp).flip(-1), -1).flip(-1)
    return ramp + torch.logcumsumexp(b - ramp, -1)


def maxplus_recurrence(a: float, b: torch.Tensor, *,
                       reverse: bool = False) -> torch.Tensor:
    """Solve x[t] = max(x[t-1] + a, b[t]) with x[-1] = -inf.

    Element t equals max_{s<=t} (b[s] + a*(t-s)), computed as
    ``a*t + cummax(b - a*t)``.  ``a`` is a Python scalar.
    """
    ramp = _ramp(a, b, reverse)
    if reverse:
        return ramp + torch.cummax((b - ramp).flip(-1), -1).values.flip(-1)
    return ramp + torch.cummax(b - ramp, -1).values
