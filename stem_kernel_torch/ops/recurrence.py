"""First-order semiring recurrences along the last axis, for a constant weight.

Port of ``stem_kernel_tpu/ops/recurrence.py``, which runs each recurrence as
an associative scan.  Here:

- sum-product, ``linear_recurrence``.  The closed form
  ``a^t * cumsum(b * a^-t)`` overflows f32 once the axis passes a few
  hundred elements at a = 0.8, so the recurrence is a product with an
  upper-triangular Toeplitz matrix

      x = b @ T,    T[s, t] = a^(t - s) for t >= s, 0 below,

  whose entries are all <= 1 for |a| <= 1: exact, and no overflow at any
  length.  A Python float ``a`` builds T once, in f64; a tensor ``a`` (one
  weight a row, constant along the axis) builds one T a row,
  T[r, s, t] = exp((t - s) * log a_r), through which autograd reaches a;
- log-semiring, ``logsumexp_recurrence``, and max-plus,
  ``maxplus_recurrence``: a doubling (Hillis-Steele) scan, log2(n) steps of

      x[..., s:] = op(x[..., s:], x[..., :-s] + a*s),    s = 1, 2, 4, ...

  with ``op`` logaddexp or maximum.  Each step combines two partial results
  of the same magnitude, as the associative scan does, so the error does
  not grow with |a| * length.  (The closed form ``a*t + logcumsumexp(b -
  a*t)`` lost 4.3e-4 at a = -15, length 300 in f32, because the ramp a*t
  reaches the thousands.)  Every row is scanned on its own, so a row's
  value never depends on the batch.  Inputs masked with a large finite
  negative stay finite.
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


def toeplitz_powers_rows(a: torch.Tensor, n: int, *, dtype=torch.float32) -> torch.Tensor:
    """(R, n, n) T with T[r, s, t] = a_r^(t-s) for t >= s, 0 below, from a
    tensor of R positive weights; differentiable in ``a``.

    The lag is clamped to 0 below the diagonal before the exp (there a
    negative lag times a negative log a would overflow), and the lower
    triangle is then zeroed by a select, not a product: the product's
    backward would multiply the bmm's gradient of those entries, which
    overflows to inf on pairs near the f32 limit, by 0 into NaN.
    """
    idx = torch.arange(n, device=a.device, dtype=torch.float64)
    lag = idx[None, :] - idx[:, None]
    log_a = torch.log(a.reshape(-1, 1, 1).to(torch.float64))
    t = torch.exp(lag.clamp(min=0) * log_a)
    return torch.where(lag >= 0, t, torch.zeros((), dtype=t.dtype, device=t.device)).to(dtype)


def linear_recurrence(a: float | torch.Tensor, b: torch.Tensor, *, reverse: bool = False,
                      matrix: torch.Tensor | None = None) -> torch.Tensor:
    """Solve x[t] = a * x[t-1] + b[t] with x[-1] = 0, along the last axis.

    Element t equals sum_{s<=t} b[s] * a^(t-s).  ``a`` is a Python scalar,
    or a tensor of one weight a row (shape ``b.shape[:-1]`` + (1,), or
    (1, 1) for all rows) through which gradients flow; ``matrix``
    optionally passes a precomputed :func:`toeplitz_powers` or
    :func:`toeplitz_powers_rows` (row loops reuse one).  ``reverse`` runs
    the recurrence from the end (Python scalar only).
    """
    n = b.shape[-1]
    if matrix is None:
        if isinstance(a, torch.Tensor):
            if reverse:
                raise ValueError("a tensor weight runs forward only")
            matrix = toeplitz_powers_rows(a, n, dtype=b.dtype)
        else:
            matrix = toeplitz_powers(a, n, dtype=b.dtype, device=b.device, reverse=reverse)
    # one (1, n) @ (n, n) product per row: a folded (rows, n) @ (n, n) GEMM
    # blocks by the row count, so a row's value would depend on how many
    # rows share the call (the Gram must not change with its batch size)
    rows = b.reshape(-1, 1, n)
    return torch.bmm(rows, matrix.reshape(-1, n, n).expand(rows.shape[0], n, n)
                     ).reshape(b.shape)


def _doubling_scan(op, a: float, b: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x[t] = op over s <= t of (b[s] + a*(t-s)) (s >= t when ``reverse``)."""
    n = b.shape[-1]
    x = b
    s = 1
    while s < n:
        shift = float(a) * s
        if reverse:
            x = torch.cat([op(x[..., :-s], x[..., s:] + shift), x[..., n - s:]], -1)
        else:
            x = torch.cat([x[..., :s], op(x[..., s:], x[..., :-s] + shift)], -1)
        s *= 2
    return x


def logsumexp_recurrence(a: float, b: torch.Tensor, *,
                         reverse: bool = False) -> torch.Tensor:
    """Solve x[t] = logaddexp(x[t-1] + a, b[t]) with x[-1] = -inf.

    Element t equals logsumexp_{s<=t} (b[s] + a*(t-s)).  ``a`` is a Python
    scalar; ``reverse`` runs the recurrence from the end.
    """
    return _doubling_scan(torch.logaddexp, a, b, reverse)


def maxplus_recurrence(a: float, b: torch.Tensor, *,
                       reverse: bool = False) -> torch.Tensor:
    """Solve x[t] = max(x[t-1] + a, b[t]) with x[-1] = -inf.

    Element t equals max_{s<=t} (b[s] + a*(t-s)).  ``a`` is a Python scalar.
    """
    return _doubling_scan(torch.maximum, a, b, reverse)
