"""Batched pairwise Gram-matrix computation on one device.

Port of ``stem_kernel_tpu/gram/engine.py`` (the reference's KernelMatrix
engine, stem_kernel/common/kernel_matrix.{h,cpp}):

- the upper-triangle pair loop becomes a flat pair-index array evaluated in
  batches by a Python loop; each batch gathers its examples' features on
  the device with ``index_select`` and runs the batched kernel;
- example features live on the device once; only pair indices go in and
  one result vector comes back, at the end of the pass;
- cosine normalization K'ij = Kij / sqrt(Kii*Kjj) (kernel_matrix.cpp:560-571),
  in log space when the kernel returns log values;
- diagonal-only and test-rows-vs-train passes, including restriction to
  support-vector columns (CalcDiagonal / CalcTestMatrix,
  kernel_matrix.cpp:59-182).
"""

from __future__ import annotations

import warnings
from typing import Callable, Mapping

import numpy as np
import torch

Features = Mapping[str, torch.Tensor]
# kernel_fn(x_batch, y_batch) -> (B,) kernel values; x/y are feature dicts
# whose tensors all share a leading batch axis.
KernelFn = Callable[[Features, Features], torch.Tensor]


def _exp_to_f32_checked(g: np.ndarray) -> np.ndarray:
    """exp of a log-domain Gram in float64, cast to float32 — warning when
    the cast overflows (log values past ~88 do not fit the f32 matrix)."""
    out = np.exp(g.astype(np.float64)).astype(np.float32)
    n_inf = int(np.sum(~np.isfinite(out)))
    if n_inf:
        warnings.warn(
            f"{n_inf} unnormalized kernel values exceed float32 range after "
            "exp; use normalize=True (log-space cosine normalization) or "
            "consume the log-domain values directly",
            RuntimeWarning,
            stacklevel=3,
        )
    return out


def normalize_gram(g: np.ndarray) -> np.ndarray:
    """Cosine normalization K'ij = Kij / sqrt(Kii*Kjj) (kernel_matrix.cpp:560-571)."""
    d = np.sqrt(np.clip(np.diag(g), 1e-300, None))
    return g / np.outer(d, d)


def to_device(features: Mapping, device) -> dict[str, torch.Tensor]:
    """Feature tensors on ``device`` (numpy arrays are converted)."""
    return {k: torch.as_tensor(v, device=device) for k, v in features.items()}


class PairKernelEngine:
    """Evaluates a batched pair kernel over stacked example features.

    ``features``: dict of tensors (or arrays) with a leading example axis,
    padded to common shapes; they are kept on ``device``.  ``kernel_fn``
    takes two gathered feature dicts (leading batch axis B) and returns (B,).
    ``log_values``: kernel_fn returns log K; gram() then normalizes in log
    space, exp(Lij - (Lii + Ljj)/2), which is exact and overflow-safe.
    """

    def __init__(self, kernel_fn: KernelFn, features: Mapping, *, device,
                 batch_size: int = 256, log_values: bool = False) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.kernel_fn = kernel_fn
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.log_values = log_values
        self.features = to_device(features, self.device)
        self.n = next(iter(self.features.values())).shape[0]

    @torch.no_grad()
    def run_pairs(self, ix: np.ndarray, iy: np.ndarray, feats_x=None,
                  feats_y=None) -> np.ndarray:
        """Kernel values (float32, host) for the pair lists (ix[p], iy[p])."""
        feats_x = self.features if feats_x is None else feats_x
        feats_y = self.features if feats_y is None else feats_y
        n_pairs = len(ix)
        out = torch.empty(n_pairs, dtype=torch.float32, device=self.device)
        ix_t = torch.as_tensor(np.asarray(ix, np.int64), device=self.device)
        iy_t = torch.as_tensor(np.asarray(iy, np.int64), device=self.device)
        for s in range(0, n_pairs, self.batch_size):
            bix = ix_t[s: s + self.batch_size]
            biy = iy_t[s: s + self.batch_size]
            x = {k: v.index_select(0, bix) for k, v in feats_x.items()}
            y = {k: v.index_select(0, biy) for k, v in feats_y.items()}
            out[s: s + len(bix)] = self.kernel_fn(x, y)
        return out.cpu().numpy()

    def gram(self, *, normalize: bool = False) -> np.ndarray:
        """Full symmetric N x N Gram matrix (upper triangle computed once)."""
        iu = np.triu_indices(self.n)
        vals = self.run_pairs(iu[0], iu[1])
        g = np.zeros((self.n, self.n), dtype=np.float32)
        g[iu] = vals
        g = g + np.triu(g, 1).T
        if self.log_values:
            if normalize:
                d = np.diag(g)
                return np.exp(g - 0.5 * (d[:, None] + d[None, :])).astype(np.float32)
            return _exp_to_f32_checked(g)
        if normalize:
            g = normalize_gram(g)
        return g

    def diagonal(self, sv_index: np.ndarray | None = None) -> np.ndarray:
        """k(x_i, x_i) for all (or the given subset of) training examples;
        entries outside ``sv_index`` stay 0 (kernel_matrix.cpp:577-633)."""
        idx = (np.arange(self.n) if sv_index is None
               else np.asarray(sv_index, np.int64))
        out = np.zeros(self.n, dtype=np.float32)
        out[idx] = self.run_pairs(idx, idx)
        return out

    def rows(self, test_features: Mapping, *, sv_index: np.ndarray | None = None,
             with_self: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """Kernel rows K(test_t, train_j) (T, N) and self values K(t, t) (T,).

        With ``sv_index`` only support-vector columns are computed (others
        stay 0), as CalcTestMatrix (kernel_matrix.cpp:112-182).
        ``with_self=False`` skips the self pass and returns zeros.
        """
        feats_t = to_device(test_features, self.device)
        n_test = next(iter(feats_t.values())).shape[0]
        cols = np.arange(self.n) if sv_index is None else np.asarray(sv_index, np.int64)
        tt, jj = np.meshgrid(np.arange(n_test), cols, indexing="ij")
        vals = self.run_pairs(tt.ravel(), jj.ravel(), feats_x=feats_t)
        rows = np.zeros((n_test, self.n), dtype=np.float32)
        rows[tt.ravel(), jj.ravel()] = vals
        if not with_self:
            return rows, np.zeros(n_test, dtype=np.float32)
        t_idx = np.arange(n_test)
        return rows, self.run_pairs(t_idx, t_idx, feats_x=feats_t, feats_y=feats_t)
