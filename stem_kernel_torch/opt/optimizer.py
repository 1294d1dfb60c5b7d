"""Outer hyperparameter-optimization loop (Optimizer::optimize equivalent).

A numpy copy of ``stem_kernel_tpu.opt.optimizer``.

Mirrors optimizer/optimizer.cpp:11-116: L-BFGS-B over
x = (C, theta...) with per-parameter bounds, objective = negated sum of
smoothed AUCs over stride-split CV folds, kernel matrix + analytic dK/dtheta
recomputed at each step by a caller-supplied function (on the card for the
BPLA kernel).
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np

from .gradient import auc_gradient_fold
from .lbfgsb import LBFGSB


def cv_split(n: int, ncv: int, fold: int) -> tuple[np.ndarray, np.ndarray]:
    """Stride split (Optimizer::split, optimizer.cpp:98-116)."""
    idx = np.arange(n)
    ts = idx[idx % ncv == fold]
    tr = idx[idx % ncv != fold]
    return tr, ts


# kernel_fn(params) -> (K (n,n), G (P,n,n)) — kernel matrix and its gradients
KernelWithGrads = Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]


def optimize_kernel_params(
    labels: np.ndarray,
    kernel_fn: KernelWithGrads,
    params0: np.ndarray,
    C0: float,
    lower: np.ndarray,
    upper: np.ndarray,
    bound_types: np.ndarray,
    *,
    ncv: int = 5,
    eps: float = 1e-3,
    factr: float = 1e7,
    pgtol: float = 1e-5,
    max_steps: int = 100,
    verbose: bool = False,
) -> tuple[np.ndarray, float, float]:
    """Returns (optimized params, optimized C, final objective -sum AUC)."""
    from .lbfgsb import LOWER_BOUND

    n_params = len(params0)
    x = np.concatenate([[C0], params0]).astype(float)
    lb = np.concatenate([[1e-5], lower])
    ub = np.concatenate([[0.0], upper])
    nbd = np.concatenate([[LOWER_BOUND], bound_types]).astype(int)

    opt = LBFGSB(factr, pgtol, max_iter=max_steps)
    opt.initialize(len(x), 5, lb, ub, nbd)

    y = np.asarray(labels)
    step = 0
    f, g = _objective(y, kernel_fn, x, ncv, eps, n_params, verbose, step)
    while True:
        step += 1
        iflag = opt.update(x, f, g)
        if iflag <= 0:
            break
        f, g = _objective(y, kernel_fn, x, ncv, eps, n_params, verbose, step)
    return x[1:], float(x[0]), f


def _objective(y, kernel_fn, x, ncv, eps, n_params, verbose, step):
    C = float(x[0])
    params = x[1:]
    K, G = kernel_fn(params)
    n = K.shape[0]
    f = 0.0
    g = np.zeros(1 + n_params)
    for fold in range(ncv):
        tr_i, ts_i = cv_split(n, ncv, fold)
        f0, fg, cg = auc_gradient_fold(K, G, y, tr_i, ts_i, C, eps)
        f -= f0
        g[0] -= cg
        g[1:] -= fg
    if verbose:
        print(f"=== step {step}: f={-f:.6f} x={x}", file=sys.stderr)
    return f, g
