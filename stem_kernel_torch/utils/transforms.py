"""Gram-matrix transforms: cosine normalization and RBF conversion.

Port of ``stem_kernel_tpu/utils/transforms.py``: equivalents of
stem_kernel/utils/normalize_matrix.rb, normalize_test_matrix.rb and
radial_basis_matrix.rb:17-33.
"""

from __future__ import annotations

import numpy as np


def normalize_matrix(g: np.ndarray) -> np.ndarray:
    """K'ij = Kij / sqrt(Kii*Kjj) for a square train Gram matrix."""
    d = np.sqrt(np.clip(np.diag(g), 1e-300, None))
    return g / np.outer(d, d)


def normalize_test_matrix(rows: np.ndarray, self_vals: np.ndarray, train_diag: np.ndarray) -> np.ndarray:
    """Normalize test-vs-train rows by sqrt(k(t,t) * k(j,j)).

    ``rows``: (T, N); ``self_vals``: (T,) k(t,t); ``train_diag``: (N,) k(j,j)
    (normalize_test_matrix.rb / framework.h:282-287).
    """
    st = np.sqrt(np.clip(self_vals, 1e-300, None))[:, None]
    sj = np.sqrt(np.clip(train_diag, 1e-300, None))[None, :]
    return rows / (st * sj)


def rbf_from_gram(g: np.ndarray, gamma: float) -> np.ndarray:
    """K'ij = exp(-gamma*(Kii + Kjj - 2*Kij)) (radial_basis_matrix.rb:17-33)."""
    d = np.diag(g)
    return np.exp(-gamma * (d[:, None] + d[None, :] - 2.0 * g))
