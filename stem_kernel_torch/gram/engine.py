"""Batched pairwise Gram-matrix computation, on one device or across ranks.

Port of ``stem_kernel_tpu/gram/engine.py`` (the reference's KernelMatrix
engine, stem_kernel/common/kernel_matrix.{h,cpp}):

- the upper-triangle pair loop becomes a flat pair-index array evaluated in
  batches by a Python loop; each batch gathers its examples' features on
  the device with ``index_select`` and runs the batched kernel;
- with a mesh (parallel.mesh), each rank runs every W-th batch on its own
  GPU and an all-gather hands every rank all the values (the reference's
  MPI rank striding, kernel_matrix.cpp:199-261);
- example features live on the device once; only pair indices go in and
  one result vector comes back, at the end of the pass;
- cosine normalization K'ij = Kij / sqrt(Kii*Kjj) (kernel_matrix.cpp:560-571),
  in log space when the kernel returns log values;
- diagonal-only and test-rows-vs-train passes, including restriction to
  support-vector columns (CalcDiagonal / CalcTestMatrix,
  kernel_matrix.cpp:59-182);
- checkpoint and resume of a pair list (gram.checkpoint) in units of
  ``slab_batches`` batches, sized by the JAX engine's slab rule.
"""

from __future__ import annotations

import warnings
from typing import Callable, Mapping

import numpy as np
import torch

from ..parallel.distributed import gather_pair_values
from ..parallel.mesh import shard_pairs
from ..utils.tracing import count, span

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


def refuse_checkpoint_across_ranks(mesh) -> None:
    """Gram checkpoints are per process: refuse one on a mesh of several
    ranks.  Every rank must run the same gathers in the same order, which
    per-rank checkpoint skips would break, and the ranks would truncate each
    other's files."""
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            "Gram checkpointing is per-process; it cannot be combined with a mesh "
            "that spans several torch.distributed ranks — run checkpointed Grams "
            "on one rank (one process, or --single-device) or drop --checkpoint")


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
    ``mesh``: a parallel.mesh.Mesh; this rank runs its share of every pair
    list's batches on ``device`` and every rank gets all the values.
    """

    def __init__(self, kernel_fn: KernelFn, features: Mapping, *, device,
                 batch_size: int = 256, slab_batches: int = 16,
                 log_values: bool = False, mesh=None) -> None:
        """``slab_batches``: batches in a checkpoint unit (the JAX engine's
        slab); it changes nothing without a checkpoint."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.kernel_fn = kernel_fn
        self.device = torch.device(device)
        self.batch_size = batch_size
        self._slab_batches = max(1, slab_batches)
        self.log_values = log_values
        self.mesh = mesh
        self.features = to_device(features, self.device)
        self.n = next(iter(self.features.values())).shape[0]

    def _slab_size(self, n_batches: int) -> int:
        """Batches in a checkpoint unit of a job of ``n_batches``: the JAX
        engine's slab rule (an exact-size unit for small jobs; past 16
        batches a power of two, halved while the padded tail exceeds 12.5%
        of the job), so a unit holds the pairs of a JAX slab."""
        sb = min(self._slab_batches, max(1, n_batches))
        if sb > 16:
            sb = 1 << (sb.bit_length() - 1)
            while sb > 16 and (-n_batches % sb) * 8 > n_batches:
                sb //= 2
        return sb

    @torch.no_grad()
    def run_pairs(self, ix: np.ndarray, iy: np.ndarray, feats_x=None,
                  feats_y=None, checkpoint=None) -> np.ndarray:
        """Kernel values (float32, host) for the pair lists (ix[p], iy[p]).

        With ``checkpoint`` (a gram.checkpoint.TileCheckpoint from
        ``checkpoint_for``), a completed unit is loaded instead of
        recomputed, and each fresh unit is copied to the host and stored
        durably as soon as it is done.  Without one, nothing waits for the
        device until the end of the pass.  With a mesh, this rank runs the
        batches ``shard_pairs`` gives it and gathers the rest.
        """
        if checkpoint is not None:
            refuse_checkpoint_across_ranks(self.mesh)
        feats_x = self.features if feats_x is None else feats_x
        feats_y = self.features if feats_y is None else feats_y
        n_pairs, bs = len(ix), self.batch_size
        ix_t = torch.as_tensor(np.asarray(ix, np.int64), device=self.device)
        iy_t = torch.as_tensor(np.asarray(iy, np.int64), device=self.device)
        n_batches = -(-n_pairs // bs)
        first = 0 if self.mesh is None else self.mesh.deal(n_batches)
        mine = shard_pairs(self.mesh, n_batches, first)
        buf = torch.zeros(len(mine) * bs, dtype=torch.float32, device=self.device)

        def run(slots: range) -> None:
            """Fill slot k of the buffer with batch mine[k]."""
            for k in slots:
                lo = mine[k] * bs
                hi = min(lo + bs, n_pairs)
                with span("gather"):
                    x = {f: v.index_select(0, ix_t[lo:hi]) for f, v in feats_x.items()}
                    y = {f: v.index_select(0, iy_t[lo:hi]) for f, v in feats_y.items()}
                with span("kernel"):
                    buf[k * bs: k * bs + hi - lo] = self.kernel_fn(x, y)
                count("gram.batches")
                count("gram.pairs", hi - lo)

        if checkpoint is None:
            run(range(len(mine)))
            with span("fetch"):  # the pass's one wait for the device
                if self.mesh is None:
                    return buf[:n_pairs].cpu().numpy()
                return gather_pair_values(buf.cpu().numpy(), n_pairs, bs, self.mesh, first)
        if checkpoint.n_pairs != n_pairs:
            raise ValueError(f"checkpoint {checkpoint.path} holds {checkpoint.n_pairs} "
                             f"pairs, not {n_pairs}")
        # one rank runs every batch here, so slot k holds batch k
        host = np.empty(n_pairs, dtype=np.float32)
        unit = checkpoint.batch_size
        for u in range(checkpoint.n_batches):
            lo, hi = u * unit, min((u + 1) * unit, n_pairs)
            if checkpoint.is_done(u):
                host[lo:hi] = checkpoint.load_batch(u)
                continue
            run(range(lo // bs, -(-hi // bs)))
            with span("fetch"):
                host[lo:hi] = buf[lo:hi].cpu().numpy()
            checkpoint.store_batch(u, host[lo:hi])
        return host

    def checkpoint_for(self, path: str, n_pairs: int | None = None,
                       n: int | None = None, extra_features=None):
        """A TileCheckpoint whose unit is this engine's slab of batches.
        Triangle by default; pass ``n_pairs`` for rectangular pair lists.

        The meta records a fingerprint of this engine's features (plus
        ``extra_features``, e.g. the y side of a rectangular block), so a
        resume against a different corpus that produces identically sized
        blocks is rejected instead of returning stale values."""
        from .checkpoint import TileCheckpoint, features_fingerprint

        refuse_checkpoint_across_ranks(self.mesh)
        n = self.n if n is None else n
        total = n * (n + 1) // 2 if n_pairs is None else n_pairs
        sb = self._slab_size(-(-total // self.batch_size))
        fp = features_fingerprint(self.features, extra_features)
        return TileCheckpoint(path, n, sb * self.batch_size, n_pairs=n_pairs,
                              fingerprint=fp)

    def gram(self, *, normalize: bool = False,
             checkpoint_path: str | None = None) -> np.ndarray:
        """Full symmetric N x N Gram matrix (upper triangle computed once).

        ``checkpoint_path`` enables unit-granular checkpoint and resume.
        """
        iu = np.triu_indices(self.n)
        ckpt = None if checkpoint_path is None else self.checkpoint_for(checkpoint_path)
        vals = self.run_pairs(iu[0], iu[1], checkpoint=ckpt)
        g = np.zeros((self.n, self.n), dtype=np.float32)
        g[iu] = vals
        g = g + np.triu(g, 1).T
        with span("normalize"):
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
