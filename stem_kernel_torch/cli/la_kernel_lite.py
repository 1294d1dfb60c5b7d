"""la_kernel (lite) CLI — standalone profile string kernel for RNA.

Port of ``stem_kernel_tpu/cli/la_kernel_lite.py`` (the reference's
stem_kernel_lite/la-main.cpp:89-133): the gap-weighted all-substrings
profile string kernel with RIBOSUM85-60 (default) or match/mismatch
substitution, and optional ``--use-bp`` per-position weights from the
unpaired-loop profiles of each row's folded BPP matrix
(string_kernel.cpp:93-110).  Defaults follow la-main.cpp: alpha=0.2,
gap=0.6, match=1.0, mismatch=0.8.

    python -m stem_kernel_torch.cli.la_kernel_lite [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) fails when no GPU is present; ``--device
cpu`` runs on the CPU.  No TPU kernel lies on this path: the string kernel
is a plain torch row scan on either device.
"""

from __future__ import annotations

import argparse

from ..models.featurize import loop_profile_weights, string_kernel_features
from ..models.string_kernel import StringKernel
from ..ops import full_f32
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)
from .stem_kernel_lite import add_fold_options, fold_opts_from


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="la_kernel_lite",
        description="Kernel Matrix Calculator for Stem Kernels "
                    "(profile string kernel)",
    )
    k = p.add_argument_group("Kernel Options")
    k.add_argument("--no-ribosum", action="store_true",
                   help="do not use the RIBOSUM substitution matrix")
    k.add_argument("--use-bp", action="store_true",
                   help="use base-pairing probability weight")
    k.add_argument("-a", "--alpha", type=float, default=0.2,
                   help="weight of the RIBOSUM for the string kernel")
    k.add_argument("-G", "--gap", type=float, default=0.6,
                   help="gap weight for the string kernel")
    k.add_argument("--match", type=float, default=1.0,
                   help="match weight for the string kernel (with --no-ribosum)")
    k.add_argument("--mismatch", type=float, default=0.8,
                   help="mismatch weight for the string kernel (with --no-ribosum)")
    add_fold_options(p)
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)
    bp_opts = fold_opts_from(ns)

    if ns.no_ribosum:
        kern = StringKernel(ns.gap, match=ns.match, mismatch=ns.mismatch)
    else:
        kern = StringKernel(ns.gap, alpha=ns.alpha)
    kern = kern.to(device)

    def featurize(alignments):
        weights = (loop_profile_weights(alignments, bp_opts, device=device)
                   if ns.use_bp else None)
        return string_kernel_features(alignments, weights=weights), None

    def kernel_fn(x, y):
        return kern(x["profile"], x["length"], y["profile"], y["length"],
                    wx=x["weight"], wy=y["weight"])

    run_app(opts, featurize, lambda _aux: kernel_fn, device=device, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
