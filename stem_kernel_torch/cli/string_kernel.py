"""string_kernel CLI — plain gap-weighted all-substrings kernel.

Port of ``stem_kernel_tpu/cli/string_kernel.py`` (the reference's
string_kernel/main.cpp:22-118: one flag -g/--gap, default 1.0; raw
sequences):

    python -m stem_kernel_torch.cli.string_kernel [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) fails when no GPU is present; ``--device
cpu`` runs on the CPU.  The kernel is a plain torch row scan on either
device.
"""

from __future__ import annotations

import argparse

from ..models.featurize import plain_string_features
from ..models.string_kernel import plain_string_kernel
from ..ops import full_f32
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="string_kernel",
        description="Kernel Matrix Calculator for String Kernels",
    )
    p.add_argument("-g", "--gap", type=float, default=1.0, help="gap weight")
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)
    gap = ns.gap

    def featurize(alignments):
        seqs = [a.ungapped_rows()[0] for a in alignments]
        return plain_string_features(seqs), None

    def kernel_fn(x, y):
        return plain_string_kernel(x["codes"], x["length"], y["codes"], y["length"], gap)

    run_app(opts, featurize, lambda _aux: kernel_fn, device=device, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
