"""stem_kernel_lite CLI — Gram matrices of stem (+ string) kernels.

Port of ``stem_kernel_tpu/cli/stem_kernel_lite.py``; usage mirrors
stem_kernel/stem_kernel_lite/main.cpp:77-231:

    python -m stem_kernel_torch.cli.stem_kernel_lite [options] output \
        label1 data1 [label2 data2 ...] [--test label file ...]

``--device cuda`` (the default) runs the hand-written kernels and fails when
no GPU is present; ``--device cpu`` runs the plain torch versions.
"""

from __future__ import annotations

import argparse

from ..fold.bpmatrix import BPMatrixOptions
from ..fold.contrafold import contrafold_energy_params, default_weights
from ..fold.params import default_params, fast_variant, load_params_file
from ..models.composite import (
    StemLiteConfig,
    featurize_stem_bucketed,
    featurize_stem_examples,
    make_stem_lite_kernel_fn,
)
from ..ops import full_f32
from .app import (
    add_common_options,
    parse_args_with_positionals,
    parse_positional,
    resolve_device,
    run_app,
)


def add_fold_options(p: argparse.ArgumentParser) -> None:
    """Folding options (BPMatrix::Options::add_options, bpmatrix.cpp:45-82)."""
    p.add_argument("--noGU", action="store_true",
                   help="disallow GU wobble base-pairs")
    p.add_argument("--noClosingGU", action="store_true",
                   help="disallow GU pairs closing hairpin/multibranch loops")
    p.add_argument("--noLonelyPairs", action="store_true",
                   help="disallow isolated base-pairs (Vienna pf heuristic: "
                        "a pair must be stackable on a canonical neighbour)")
    p.add_argument("--use-alifold", action="store_true",
                   help="use consensus folding for alignments (bpla_kernel, "
                        "bpla_optimizer; the stem and string kernels fold each "
                        "row, as the JAX package does)")
    p.add_argument("--use-contrafold", metavar="PARAMS", default=None,
                   help="fold with the CONTRAfold CLLM (fold.contrafold): "
                        "PARAMS is a CONTRAfold-format weight file, a "
                        "Vienna .par, or the literal 'default' for the "
                        "shipped thermodynamically-seeded weights")
    p.add_argument("--fast-fold", action="store_true",
                   help="fast folding tier: drop the int11/int21/int22/"
                        "bulge-1 special tables and collapse the interior "
                        "mismatch classes (generic-formula energies for "
                        "every loop)")


def fold_opts_from(ns: argparse.Namespace) -> BPMatrixOptions:
    """Folding options (BPMatrix::Options, common/bpmatrix.cpp:45-82): the
    model (Turner, or CONTRAfold weights), then the gate flags applied to
    the model already chosen."""
    opts = BPMatrixOptions(alifold=ns.use_alifold)
    if ns.use_contrafold:
        if ns.use_contrafold == "default":
            opts.params = contrafold_energy_params(default_weights())
        else:
            opts.params = load_params_file(ns.use_contrafold)
    if ns.noGU or ns.noClosingGU or ns.noLonelyPairs:
        params = opts.params or default_params()
        params.no_gu = bool(ns.noGU)
        params.no_closing_gu = bool(ns.noClosingGU)
        params.no_lonely_pairs = bool(ns.noLonelyPairs)
        opts.params = params
    if ns.fast_fold:
        opts.params = fast_variant(opts.params or default_params())
    return opts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stem_kernel_lite",
        description="Kernel Matrix Calculator for Stem Kernels",
    )
    k = p.add_argument_group("Kernel Options")
    k.add_argument("--no-ribosum", action="store_true",
                   help="do not use the RIBOSUM substitution matrix")
    k.add_argument("--no-string", action="store_true",
                   help="do not convolute the string kernel")
    k.add_argument("--log", action="store_true",
                   help="use the logarithm of the kernel")
    s = p.add_argument_group("Options for the stem kernel")
    s.add_argument("-p", "--basepair", type=float, default=0.01,
                   help="threshold of basepairing probability")
    s.add_argument("-b", "--beta", type=float, default=0.3,
                   help="weight of the RIBOSUM for the stem kernel")
    s.add_argument("-g", "--loop-gap", type=float, default=0.2,
                   help="gap weight for loop regions")
    s.add_argument("-s", "--stack", type=float, default=1.3,
                   help="match weight for stacking base pairs (with --no-ribosum)")
    s.add_argument("-v", "--covariant", type=float, default=0.8,
                   help="substitution weight for base pairs (with --no-ribosum)")
    s.add_argument("--precision", choices=["highest", "high", "default"],
                   default="high",
                   help="closure fixed point products on the card, at every node "
                        "count: highest = f32, high = 3xTF32 (about 1e-5 from f32), "
                        "default = bf16 operands with f32 sums; --device cpu runs f32 "
                        "for every name")
    s.add_argument("--length-band", type=int, default=10,
                   help="band of length difference between bases")
    s.add_argument("--coarse-shapes", action="store_true",
                   help="a TPU compile-count option; not part of this port")
    t = p.add_argument_group("Options for the string kernel")
    t.add_argument("-a", "--alpha", type=float, default=0.2,
                   help="weight of the RIBOSUM for the string kernel")
    t.add_argument("-G", "--gap", type=float, default=0.8,
                   help="gap weight for the string kernel")
    t.add_argument("--match", type=float, default=1.0,
                   help="match weight for the string kernel (with --no-ribosum)")
    t.add_argument("--mismatch", type=float, default=0.8,
                   help="mismatch weight for the string kernel (with --no-ribosum)")
    add_fold_options(p)
    add_common_options(p)
    return p


def main(argv=None) -> int:
    full_f32()  # plain f32 products stay f32 on the card
    p = build_parser()
    ns = parse_args_with_positionals(p, argv)
    if ns.coarse_shapes:
        p.error("--coarse-shapes bounds TPU compile counts and is not part of "
                "stem_kernel_torch")
    device = resolve_device(ns.device)
    opts = parse_positional(ns)
    config = StemLiteConfig(
        th=ns.basepair, beta=ns.beta, loop_gap=ns.loop_gap, stack=ns.stack,
        covar=ns.covariant, len_band=ns.length_band, alpha=ns.alpha, gap=ns.gap,
        str_match=ns.match, str_mismatch=ns.mismatch, no_ribosum=ns.no_ribosum,
        no_string=ns.no_string, use_log=ns.log, bp_opts=fold_opts_from(ns),
        precision=ns.precision,
    )
    run_app(
        opts,
        lambda alns: featurize_stem_examples(alns, config, device=device),
        lambda iters: make_stem_lite_kernel_fn(config, iters, device=device),
        device=device,
        featurize_buckets=lambda alns: featurize_stem_bucketed(alns, config, device=device),
        merge_aux=max,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
