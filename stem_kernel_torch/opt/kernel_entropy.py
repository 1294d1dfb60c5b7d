"""Kernel-entropy objective (the vestigial stem_train trainer).

A numpy copy of ``stem_kernel_tpu.opt.kernel_entropy``.

Equivalent of stem_kernel/train.cpp:86-237 (the `stem_train`
binary, commented out of the reference build but kept in-tree): maximize the
von Neumann kernel entropy tr(K log K) over kernel parameters, with
d f / d theta = tr(dK/dtheta (I + log K)) and optional cosine normalization
chain-ruled through (train.cpp:142-170).  Matrix log via symmetric
eigendecomposition (the dsyev path) in NumPy; the outer loop is plain
L-BFGS (the reference used netlib lbfgs.c).
"""

from __future__ import annotations

import numpy as np

from .lbfgsb import LBFGSB, UNBOUND


def kernel_entropy(K: np.ndarray, G: np.ndarray, *, normalize: bool = False):
    """(f, df/dparams) with f = tr(K log K).

    K: (n, n) PSD kernel matrix; G: (P, n, n) parameter gradients.
    """
    K = np.asarray(K, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    if normalize:
        d = np.sqrt(np.clip(np.diag(K), 1e-300, None))
        Kn = K / np.outer(d, d)
        np.fill_diagonal(Kn, 1.0)
        Gd = np.einsum("pii->pi", G)
        Gn = (
            G / np.outer(d, d)[None]
            - 0.5 * Kn[None] * (Gd[:, :, None] / (d**2)[None, :, None])
            - 0.5 * Kn[None] * (Gd[:, None, :] / (d**2)[None, None, :])
        )
        for p in range(G.shape[0]):
            np.fill_diagonal(Gn[p], 0.0)
        K, G = Kn, Gn
    w, V = np.linalg.eigh(K)
    w = np.clip(w, 1e-12, None)
    log_K = (V * np.log(w)) @ V.T
    f = float(np.trace(K @ log_K))
    I_logK = np.eye(len(K)) + log_K
    g = np.einsum("pij,ji->p", G, I_logK)
    return f, g


def maximize_kernel_entropy(
    kernel_fn,
    params0: np.ndarray,
    *,
    normalize: bool = False,
    max_iter: int = 50,
) -> tuple[np.ndarray, float]:
    """L-BFGS ascent on tr(K log K); kernel_fn(params) -> (K, G)."""
    x = np.asarray(params0, dtype=float).copy()
    opt = LBFGSB(max_iter=max_iter)
    opt.initialize(len(x), 5, np.zeros(len(x)), np.zeros(len(x)),
                   [UNBOUND] * len(x))

    def fg(p):
        K, G = kernel_fn(p)
        f, g = kernel_entropy(K, G, normalize=normalize)
        return -f, -g  # minimize the negative entropy

    f, g = fg(x)
    while opt.update(x, f, g) > 0:
        f, g = fg(x)
    return x, -f
