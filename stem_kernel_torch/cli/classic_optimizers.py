"""rbf_optimizer / poly_optimizer / sigmoid_optimizer CLIs.

Equivalents of optimizer/{rbf,poly,sigmoid}_optimizer.cpp:
L-BFGS-B over (C, kernel params) with the smoothed-AUC CV objective on
feature-vector data in LIBSVM sparse format.

A numpy copy of ``stem_kernel_tpu/cli/classic_optimizers.py``: these
kernels are a few host matrix products, so nothing runs on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..opt.classic import (
    poly_kernel_with_grads,
    rbf_kernel_with_grads,
    sigmoid_kernel_with_grads,
)
from ..opt.lbfgsb import LOWER_BOUND, UNBOUND
from ..opt.optimizer import optimize_kernel_params


def load_libsvm_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(labels, dense feature matrix) from LIBSVM sparse 'y i:v ...' lines."""
    ys: list[float] = []
    rows: list[dict[int, float]] = []
    max_idx = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ys.append(float(parts[0]))
            row: dict[int, float] = {}
            for cell in parts[1:]:
                idx, val = cell.split(":")
                row[int(idx)] = float(val)
                max_idx = max(max_idx, int(idx))
            rows.append(row)
    X = np.zeros((len(rows), max_idx), dtype=np.float64)
    for i, row in enumerate(rows):
        for idx, val in row.items():
            X[i, idx - 1] = val
    return np.asarray(ys), X


def _run(kind: str, argv) -> int:
    p = argparse.ArgumentParser(prog=f"{kind}_optimizer")
    p.add_argument("-C", type=float, default=1.0, dest="C")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--coef0", type=float, default=0.0)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--fold", type=int, default=5)
    p.add_argument("data", help="training data in LIBSVM sparse format")
    ns = p.parse_args(argv)
    y, X = load_libsvm_file(ns.data)
    y = np.where(y > 0, 1.0, -1.0)

    if kind == "rbf":
        params0 = np.array([ns.gamma])
        lower, upper = np.array([1e-6]), np.array([0.0])
        nbd = np.array([LOWER_BOUND])
        fn = lambda p_: rbf_kernel_with_grads(X, p_)
    elif kind == "poly":
        params0 = np.array([ns.gamma, ns.coef0])
        lower, upper = np.array([1e-6, 0.0]), np.array([0.0, 0.0])
        nbd = np.array([LOWER_BOUND, UNBOUND])
        fn = lambda p_: poly_kernel_with_grads(X, p_, ns.degree)
    else:
        params0 = np.array([ns.gamma, ns.coef0])
        lower, upper = np.array([1e-6, 0.0]), np.array([0.0, 0.0])
        nbd = np.array([LOWER_BOUND, UNBOUND])
        fn = lambda p_: sigmoid_kernel_with_grads(X, p_)

    params, C, f = optimize_kernel_params(
        y, fn, params0, ns.C, lower=lower, upper=upper, bound_types=nbd,
        ncv=ns.fold, verbose=True,
    )
    print(f"Optimized Parameters:\n  C={C:g}, params={params}")
    return 0


def rbf_main(argv=None) -> int:
    return _run("rbf", argv)


def poly_main(argv=None) -> int:
    return _run("poly", argv)


def sigmoid_main(argv=None) -> int:
    return _run("sigmoid", argv)
