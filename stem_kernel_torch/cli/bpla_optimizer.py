"""bpla_optimizer CLI — gradient-based BPLA hyperparameter fitting.

Port of ``stem_kernel_tpu/cli/bpla_optimizer.py`` (the reference's
bpla_kernel/bpla_optimizer.cpp:317-452): optimize (C, alpha, beta, gap,
ext) by L-BFGS-B over a smoothed-AUC CV objective, with the kernel matrix
and its parameter gradients recomputed each step, in batches of pairs over
the upper triangle on one device: values from the 7-state flank scan and
gradients by autograd through it (``models.bpla.bpla_kernel_batch``).

    python -m stem_kernel_torch.cli.bpla_optimizer [options] \
        label1 data1 [label2 data2 ...]

``--device cuda`` (the default) fails when no GPU is present; ``--device
cpu`` runs on the CPU.  Bounds (bpla_optimizer.cpp:419-426): alpha >= 1e-3;
beta in [1e-3, 0.3]; gap, ext <= 0; C >= 1e-5.  The values are f32, as in
the JAX package: at the default parameters they overflow near 70 nt of
well-matched sequence, and such pairs give inf or NaN.  Without ``-n``, K
of 50-60 nt sequences reaches 1e29, where the SMO's stopping test (1e-3 on
gradients of that size) lies below f64 resolution: the solver may then run
to its iteration cap.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..fold.bpmatrix import BPMatrixOptions, bpp_for_alignments
from ..gram.engine import to_device
from ..models.bpla import (
    DEFAULT_BPLA_SCORE_TABLE, bpla_kernel_batch, bpla_score_parts, pair_mask,
)
from ..models.featurize import bpla_features
from ..ops import full_f32
from ..opt.lbfgsb import BOTH_BOUNDS, LOWER_BOUND, UPPER_BOUND
from ..opt.optimizer import optimize_kernel_params
from .app import load_labeled, parse_args_with_positionals, resolve_device
from .bpla_kernel import read_score_table

# bounds of (alpha, beta, gap, ext) (bpla_optimizer.cpp:419-426)
LOWER = np.array([1e-3, 1e-3, -1e30, -1e30])
UPPER = np.array([1e30, 0.3, 0.0, 0.0])
BOUND_TYPES = np.array([LOWER_BOUND, BOTH_BOUNDS, UPPER_BOUND, UPPER_BOUND])


def bpla_matrix_with_grads(
    feats: dict[str, np.ndarray],
    score_table: np.ndarray,
    params: np.ndarray,
    *,
    device,
    batch_size: int = 256,
    normalize: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(K, dK/dparams) over all examples, float64 on the host.

    params = (alpha, beta, gap, ext).  The features move to ``device`` once;
    each batch of upper-triangle pairs builds (w_pair, w_unpair) and takes
    one forward and one backward pass.  Values and gradients stay f32 on
    the device until the last batch, and the cosine normalisation runs on
    the host in f64.
    """
    full_f32()
    n = feats["profile"].shape[0]
    iu = np.triu_indices(n)
    dev = torch.device(device)
    st = torch.as_tensor(np.asarray(score_table, np.float32), device=dev)
    feats_d = to_device(feats, dev)
    ix_t = torch.as_tensor(iu[0], device=dev)
    iy_t = torch.as_tensor(iu[1], device=dev)
    vals, grads = [], []
    for start in range(0, len(iu[0]), batch_size):
        bx, by = ix_t[start: start + batch_size], iy_t[start: start + batch_size]
        x = {k: v.index_select(0, bx) for k, v in feats_d.items()}
        y = {k: v.index_select(0, by) for k, v in feats_d.items()}
        w_pair, w_unpair = bpla_score_parts(
            x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
            y["profile"], y["p_left"], y["p_right"], y["p_unpair"], st,
        )
        mask = pair_mask(x["length"], w_pair.shape[1], y["length"], w_pair.shape[2])
        v, g = bpla_kernel_batch(w_pair, w_unpair, mask, params, with_grads=True)
        vals.append(v)
        grads.append(g)
    vals = torch.cat(vals).cpu().numpy().astype(np.float64)
    grads = torch.cat(grads).cpu().numpy().astype(np.float64)

    K = np.zeros((n, n))
    G = np.zeros((4, n, n))
    K[iu] = vals
    K[iu[1], iu[0]] = vals
    for p in range(4):
        G[p][iu] = grads[:, p]
        G[p][iu[1], iu[0]] = grads[:, p]

    if normalize:
        d = np.clip(np.diag(K), 1e-300, None)
        sq = np.sqrt(np.outer(d, d))
        Kn = K / sq
        Gn = np.empty_like(G)
        for p in range(4):
            gd = np.diag(G[p])
            Gn[p] = (G[p] - 0.5 * K * (gd[:, None] / d[:, None] + gd[None, :] / d[None, :])) / sq
        return Kn, Gn
    return K, G


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bpla_optimizer",
        description="Hyperparameter optimizer for BPLA kernels",
    )
    p.add_argument("-g", "--gap", type=float, default=-8.0)
    p.add_argument("-e", "--ext", type=float, default=-0.75)
    p.add_argument("-a", "--alpha", type=float, default=4.5)
    p.add_argument("-b", "--beta", type=float, default=0.11)
    p.add_argument("-C", type=float, default=1.0, dest="C")
    p.add_argument("--fold", type=int, default=5, help="CV folds")
    p.add_argument("--score", default="", help="score table file")
    p.add_argument("-n", "--normalize", action="store_true")
    p.add_argument("--use-alifold", action="store_true",
                   help="use consensus folding for alignments")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the kernel values and gradients: 'cuda' (fails "
                        "when no GPU is present) or 'cpu'")
    return p


def main(argv=None) -> int:
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    # positionals: label1 file1 [label2 file2 ...]  (no output file)
    rest = ns.args
    labels_files = list(zip(rest[0::2], rest[1::2]))
    alns, labels = load_labeled([l for l, _ in labels_files], [f for _, f in labels_files])
    y = np.array([1.0 if l in ("+1", "1") else -1.0 for l in labels])

    score_table = read_score_table(ns.score) if ns.score else DEFAULT_BPLA_SCORE_TABLE
    feats = bpla_features(alns, bpp_for_alignments(
        alns, BPMatrixOptions(alifold=ns.use_alifold), device=device))

    def kernel_fn(params):
        return bpla_matrix_with_grads(feats, score_table, params, device=device,
                                      normalize=ns.normalize)

    params, C, f = optimize_kernel_params(
        y, kernel_fn,
        np.array([ns.alpha, ns.beta, ns.gap, ns.ext]), ns.C,
        lower=LOWER, upper=UPPER, bound_types=BOUND_TYPES, ncv=ns.fold, verbose=True,
    )
    print(
        f"Optimized Parameters:\n  C={C:g}, alpha={params[0]:g}, "
        f"beta={params[1]:g}, gap={params[2]:g}, ext={params[3]:g}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
