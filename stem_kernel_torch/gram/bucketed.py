"""Gram assembly over shape-buckets of examples.

Port of ``stem_kernel_tpu/gram/bucketed.py``.  Examples are grouped into
geometric shape buckets (models.composite.featurize_stem_bucketed) and the
Gram is assembled block by block over bucket pairs, each block at the pad
shapes of its two buckets only, so one large outlier does not inflate every
kernel evaluation (the reference streams exact-size examples,
stem_kernel/common/kernel_matrix.cpp:44-56).
"""

from __future__ import annotations

import os
from typing import Callable, Mapping

import numpy as np
import torch

from .engine import (
    PairKernelEngine,
    _exp_to_f32_checked,
    normalize_gram,
    refuse_checkpoint_across_ranks,
    to_device,
)
from ..utils.tracing import span

# bucket: (global example indices, stacked features, aux e.g. iteration bound)
Bucket = tuple[np.ndarray, Mapping[str, torch.Tensor], object]


def bucketed_gram(
    buckets: list[Bucket],
    make_kernel_fn: Callable[[object], Callable],
    *,
    device,
    normalize: bool = False,
    batch_size: int = 256,
    log_values: bool = False,
    merge_aux: Callable[[object, object], object] = max,
    checkpoint_path: str | None = None,
    mesh=None,
) -> np.ndarray:
    """Full N x N Gram from bucketed features.

    ``make_kernel_fn(aux)`` builds the batched kernel for a block whose two
    buckets' aux values merge via ``merge_aux`` (default max, right for
    iteration-count bounds).

    ``checkpoint_path``: directory of per-block checkpoints ``block_{p}_{q}``
    in the engine's units (gram.checkpoint); a restarted run skips every
    completed unit of every block.

    ``mesh``: the ranks that share each block's batches (parallel.mesh).
    """
    if checkpoint_path is not None:
        refuse_checkpoint_across_ranks(mesh)
        os.makedirs(checkpoint_path, exist_ok=True)
    n = sum(len(idx) for idx, _, _ in buckets)
    g = np.zeros((n, n), dtype=np.float32)
    for p, (idx_p, feats_p, aux_p) in enumerate(buckets):
        for q in range(p, len(buckets)):
            with span("block"):
                idx_q, feats_q, aux_q = buckets[q]
                eng = PairKernelEngine(make_kernel_fn(merge_aux(aux_p, aux_q)), feats_p,
                                       device=device, batch_size=batch_size,
                                       log_values=log_values, mesh=mesh)
                ckpt = None
                if checkpoint_path is not None:
                    n_pairs = (len(idx_p) * (len(idx_p) + 1) // 2 if p == q
                               else len(idx_p) * len(idx_q))
                    # the y-side features join the fingerprint of a cross block,
                    # so a corpus with same-sized buckets is rejected
                    ckpt = eng.checkpoint_for(
                        os.path.join(checkpoint_path, f"block_{p}_{q}"), n_pairs=n_pairs,
                        n=len(idx_p), extra_features=None if p == q else feats_q)
                if p == q:
                    ix, iy = np.triu_indices(len(idx_p))
                    vals = eng.run_pairs(ix, iy, checkpoint=ckpt)
                    g[idx_p[ix], idx_p[iy]] = vals
                    g[idx_p[iy], idx_p[ix]] = vals
                else:
                    tt, jj = np.meshgrid(np.arange(len(idx_p)), np.arange(len(idx_q)),
                                         indexing="ij")
                    tt, jj = tt.ravel(), jj.ravel()
                    vals = eng.run_pairs(tt, jj, feats_y=to_device(feats_q, eng.device),
                                         checkpoint=ckpt)
                    g[idx_p[tt], idx_q[jj]] = vals
                    g[idx_q[jj], idx_p[tt]] = vals
    with span("normalize"):
        if log_values:
            if normalize:
                d = np.diag(g)
                return np.exp(g - 0.5 * (d[:, None] + d[None, :])).astype(np.float32)
            return _exp_to_f32_checked(g)
        if normalize:
            g = normalize_gram(g)
        return g
