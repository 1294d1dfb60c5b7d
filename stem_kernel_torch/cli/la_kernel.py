"""la_kernel CLI — protein local-alignment kernel with BLOSUM62.

Port of ``stem_kernel_tpu/cli/la_kernel.py``: the BPLA machinery with noBP
semantics on amino-acid profiles (defaults gap=-10, ext=-1, beta=0.11):

    python -m stem_kernel_torch.cli.la_kernel [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) runs the hand-written kernels and fails when
no GPU is present; ``--device cpu`` runs the plain torch versions.  The
kernel is evaluated in exp space, as in the JAX package: its values
overflow f32 past about 90 well-matched residues.
"""

from __future__ import annotations

import argparse

import torch

from ..io.aaprofile import aa_features
from ..models.blosum_data import BLOSUM62
from ..models.bpla import la_score_matrix, local_alignment_max, pair_mask
from ..ops import full_f32
from ..ops.la import la_exp_auto
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="la_kernel", description="Kernel Matrix Calculator for Local Alignment Kernels"
    )
    p.add_argument("-g", "--gap", type=float, default=-10.0)
    p.add_argument("-e", "--ext", type=float, default=-1.0)
    p.add_argument("-b", "--beta", type=float, default=0.11)
    p.add_argument("--SW", action="store_true",
                   help="Smith-Waterman kernel instead of local alignment kernel")
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()  # plain f32 products stay f32 on the card
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)
    table = torch.as_tensor(BLOSUM62, device=device)

    def kernel_fn(x, y):
        s = la_score_matrix(x["profile"], y["profile"], table)
        if ns.SW:
            mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
            return local_alignment_max(s, mask, ns.gap, ns.ext)
        return la_exp_auto(s, x["length"], y["length"], ns.beta, ns.gap, ns.ext)

    run_app(opts, lambda alns: (aa_features(alns), None), lambda _aux: kernel_fn,
            device=device, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
