"""bpla_kernel CLI — Gram matrices of BPLA (base-pair local-alignment) kernels.

Port of ``stem_kernel_tpu/cli/bpla_kernel.py`` (flags --noBP, --SW,
gap/ext/alpha/beta, --score table file):

    python -m stem_kernel_torch.cli.bpla_kernel [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) runs the hand-written kernels and fails when
no GPU is present; ``--device cpu`` runs the plain torch versions.  The
non-SW kernel is evaluated in log space, with log-space normalization.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..fold.bpmatrix import bpp_for_alignments
from ..io.alphabet import encode
from ..models.bpla import DEFAULT_BPLA_SCORE_TABLE, BPLAKernel
from ..models.featurize import bpla_features
from ..ops import full_f32
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)
from .stem_kernel_lite import add_fold_options, fold_opts_from


def read_score_table(path: str) -> np.ndarray:
    """'a b v' lines -> 4x4 table over the default (read_score_table)."""
    table = DEFAULT_BPLA_SCORE_TABLE.copy()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                a, b, v = parts
                table[encode(a.lower())[0], encode(b.lower())[0]] = float(v)
    return table


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bpla_kernel",
        description="Kernel Matrix Calculator for BPLA Kernels",
    )
    k = p.add_argument_group("Kernel Options")
    k.add_argument("--noBP", action="store_true",
                   help="do not use base-pairing profiles (plain LA kernel)")
    k.add_argument("--SW", action="store_true",
                   help="Smith-Waterman kernel instead of local alignment kernel")
    k.add_argument("-g", "--gap", type=float, default=-8.0, help="gap weight")
    k.add_argument("-e", "--ext", type=float, default=-0.75, help="extension weight")
    k.add_argument("-a", "--alpha", type=float, default=4.5, help="alpha")
    k.add_argument("-b", "--beta", type=float, default=0.11, help="beta")
    k.add_argument("--score", default="", help="score table file")
    add_fold_options(p)
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()  # plain f32 products stay f32 on the card
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)
    score_table = read_score_table(ns.score) if ns.score else None
    kernel = BPLAKernel(score_table, no_bp=ns.noBP, sw=ns.SW, gap=ns.gap, ext=ns.ext,
                        alpha=ns.alpha, beta=ns.beta).to(device)
    bp_opts = fold_opts_from(ns)

    def featurize(alignments):
        bpps = bpp_for_alignments(alignments, bp_opts, device=device)
        return bpla_features(alignments, bpps), None

    # the LA values overflow f32 on long sequences, so the non-SW path runs
    # in log space (exact log-space normalization)
    use_log = not ns.SW
    run_app(opts, featurize, lambda _aux: kernel.log_value if use_log else kernel,
            device=device, log_kernel=use_log, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
