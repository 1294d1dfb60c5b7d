"""stem_kernel CLI — the full O(n^4) stem kernel (reference implementation).

Port of ``stem_kernel_tpu/cli/stem_kernel.py`` (the reference's
main.cpp:36-150): gap/stack/substitution/loop weights, optional GU wobble
pairs, a base-pair probability bound (pair weights from folded BPP
matrices), a diagonal band width and PHMM alignment constraints:

    python -m stem_kernel_torch.cli.stem_kernel [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

Routes: ``-b W`` runs the banded windowed-memory engine in log space
(:func:`..ops.full_stem_banded.full_stem_banded_log`, K6 on the card), with
``-a p`` anchored on the PHMM alignment; without ``-b`` the dense engine
runs, with ``-a p`` restricted to the PHMM posterior windows.
``--device cuda`` (the default) fails when no GPU is present; ``--device
cpu`` runs the plain torch versions.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..fold.bpmatrix import fold_sequences
from ..io.alphabet import encode
from ..models.full_stem import full_stem_kernel, pair_weights
from ..models.phmm import posterior_windows
from ..ops import full_f32
from ..ops.full_stem_banded import full_stem_banded_log
from ..utils.tracing import span
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stem_kernel", description="Kernel Matrix Calculator for Stem Kernels (full DP)"
    )
    p.add_argument("-g", "--gap", type=float, default=0.8, help="gap weight")
    p.add_argument("-s", "--stack", type=float, default=1.0, help="stacking weight")
    p.add_argument("-l", "--loop", type=int, default=3, help="minimum loop length")
    p.add_argument("-v", "--substitution", type=float, default=0.5,
                   help="substitution weight for base pairs")
    p.add_argument("-p", "--basepair-probability", type=float, default=0.0,
                   help=">0: use folded BPP matrices with this bound")
    p.add_argument("--noGU", action="store_true", help="disallow GU pairs")
    p.add_argument("-b", "--band-width", type=int, default=0,
                   help="diagonal band width for the match region")
    p.add_argument("-a", "--alignment-constraint", type=float, default=0.0,
                   help="PHMM MAP-path posterior bound for banding")
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()  # plain f32 products stay f32 on the card
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    device = resolve_device(ns.device)
    opts = parse_positional(ns)

    def featurize(alignments):
        seqs = [a.ungapped_rows()[0] for a in alignments]
        n = max(len(s) for s in seqs) + 1
        codes = np.zeros((len(seqs), n), np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        bp = np.zeros((len(seqs), n, n), np.float32)
        bpps = None
        if ns.basepair_probability > 0:
            bpps = fold_sequences(seqs, device=device)
        with span("pair_weights"):
            for i, s in enumerate(seqs):
                c = encode(s)
                codes[i, : len(c)] = c
                lens[i] = len(c)
                bp[i, : len(c), : len(c)] = pair_weights(
                    c, len(c), use_GU=not ns.noGU, min_loop=ns.loop,
                    bpp=None if bpps is None else bpps[i],
                    bp_bound=ns.basepair_probability,
                )
        return {"codes": codes, "length": lens, "bp": bp}, None

    # -b: the banded engine, log-valued and rescaled, so no f32 overflow at
    # any length (partial_dp's band branch, stem_kernel.cpp:70-76,165-246);
    # -a > 0 anchors its windows on the PHMM alignment.  Without -b, the
    # dense O(n^4)-state engine, with or without posterior windows.
    use_banded = ns.band_width > 0

    def banded_fn(x, y):
        return full_stem_banded_log(
            x["codes"], y["codes"], x["length"], y["length"], x["bp"], y["bp"],
            ns.gap, ns.stack, ns.substitution,
            band=ns.band_width, ali_bound=ns.alignment_constraint)

    def dense_fn(x, y):
        win_lo = win_hi = None
        if ns.alignment_constraint > 0.0:
            win_lo, win_hi = posterior_windows(
                x["codes"], x["length"], y["codes"], y["length"],
                ns.alignment_constraint, ns.band_width)
        return full_stem_kernel(
            x["codes"], y["codes"], x["length"], y["length"], x["bp"], y["bp"],
            ns.gap, ns.stack, ns.substitution,
            band=0 if win_lo is not None else ns.band_width,
            win_lo=win_lo, win_hi=win_hi)

    run_app(opts, featurize, lambda _aux: banded_fn if use_banded else dense_fn,
            device=device, batch_size=16, log_kernel=use_banded)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
