"""simpal CLI — palindrome-kernel Gram matrices.

Port of ``stem_kernel_tpu/cli/simpal.py`` (the reference's
simpal/simpal.cpp:308-424: flags seed-length, min-loop, tolerance,
max-distance):

    python -m stem_kernel_torch.cli.simpal [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) folds and evaluates the kernel on the GPU
and fails when none is present; ``--device cpu`` runs on the CPU.  The
palindrome features are host numpy.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..fold.bpmatrix import fold_sequences
from ..models.simpal import pal_features, simpal_kernel_fn
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simpal", description="Kernel Matrix Calculator for Palindrome Kernels"
    )
    p.add_argument("-s", "--seed-length", type=int, default=3)
    p.add_argument("-l", "--min-loop", type=int, default=3)
    p.add_argument("--tolerance", type=int, default=1)
    p.add_argument("-m", "--max-distance", type=int, default=300)
    add_common_options(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)

    def featurize(alignments):
        seqs = [a.ungapped_rows()[0] for a in alignments]
        bpps = fold_sequences(seqs, device=device)
        feats = np.stack([
            pal_features(s, b, seed_length=ns.seed_length,
                         min_loop=ns.min_loop, max_dist=ns.max_distance)
            for s, b in zip(seqs, bpps)
        ])
        return {"pal": feats}, None

    kernel_fn = simpal_kernel_fn(ns.seed_length, ns.tolerance, ns.max_distance,
                                 device=device)
    run_app(opts, featurize, lambda _aux: kernel_fn, device=device, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
