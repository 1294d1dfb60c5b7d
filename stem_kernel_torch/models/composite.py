"""The stem_kernel_lite kernel family: stem (+ string) compositions.

Port of ``stem_kernel_tpu/models/composite.py`` (the named kernels of
stem_kernel/stem_kernel_lite/def_kernel.h: SuStemKernel, SiStemKernel,
SuStemStrKernel, SiStemStrKernel, LSuStemKernel, LSuStemStrKernel) and the
featurization that turns parsed alignments into stacked, padded feature
tensors on the device (fold -> DAG -> closures; profile tensors +
loop-profile weights for the string part).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fold.bpmatrix import BPMatrixOptions, average_bpp, fold_sequences
from ..io.alphabet import N_RNA
from ..io.profile import Alignment, profile_from_alignment
from ..utils.tracing import span
from . import combinators
from .dag import build_dag, closure_features, dag_operators
from .stem_kernel import StemKernel
from .string_kernel import StringKernel


@dataclass
class StemLiteConfig:
    """Flag surface of stem_kernel_lite (main.cpp:100-163 defaults)."""

    th: float = 0.01  # --basepair
    beta: float = 0.3  # stem RIBOSUM weight
    loop_gap: float = 0.2
    stack: float = 1.3  # --no-ribosum match
    covar: float = 0.8  # --no-ribosum mismatch
    len_band: int = 10
    alpha: float = 0.2  # string RIBOSUM weight
    gap: float = 0.8  # string gap
    str_match: float = 1.0
    str_mismatch: float = 0.8
    no_ribosum: bool = False
    no_string: bool = False
    use_log: bool = False
    bp_opts: BPMatrixOptions = field(default_factory=BPMatrixOptions)
    node_pad_multiple: int = 16
    len_pad_multiple: int = 8
    # the fixed point's product mode on the card: "highest" f32, "high" 3xTF32,
    # "default" bf16 (ops/stem_fixed_point.py:MODES); f32 on the CPU
    precision: str = "high"


def build_stem_dags(alignments: list[Alignment], config: StemLiteConfig, *, device):
    """Fold every alignment row (batched on ``device``) and build the DAGs."""
    flat_rows: list[str] = []
    spans: list[tuple[int, int]] = []
    for a in alignments:
        rows = a.ungapped_rows()
        spans.append((len(flat_rows), len(rows)))
        flat_rows.extend(rows)
    row_bpps = fold_sequences(flat_rows, config.bp_opts, device=device)

    dags = []
    with span("dag"):
        for a, (start, cnt) in zip(alignments, spans):
            bpps = row_bpps[start: start + cnt]
            avg = average_bpp(a, bpps)
            dags.append(build_dag(a, avg, bpps, th=config.th))
    return dags


def _pack_stem_features(alignments: list[Alignment], dags, config: StemLiteConfig,
                        n_pad: int, lmax: int, device) -> dict[str, torch.Tensor]:
    """Stacked feature tensors on ``device`` for the given examples and pads."""
    with span("pack"):
        dag_feats = [dag_operators(d, config.loop_gap, n_pad) for d in dags]
        stacked = {k: np.stack([f[k] for f in dag_feats]) for k in dag_feats[0]}
        feats = closure_features(stacked, device)

        if not config.no_string:
            prof = np.zeros((len(alignments), lmax, N_RNA), np.float32)
            wts = np.zeros((len(alignments), lmax), np.float32)
            lens = np.zeros(len(alignments), np.int32)
            for i, (a, d) in enumerate(zip(alignments, dags)):
                p = profile_from_alignment(a)
                L = p.shape[0]
                base = p[:, :N_RNA]
                tot = base.sum(axis=1, keepdims=True)
                prof[i, :L] = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0)
                wts[i, :L] = d.pos_weight  # loop profiles weight the string kernel
                lens[i] = L
            feats["str_profile"] = torch.as_tensor(prof, device=device)
            feats["str_weight"] = torch.as_tensor(wts, device=device)
            feats["str_length"] = torch.as_tensor(lens, device=device)
        return feats


def featurize_stem_examples(alignments: list[Alignment], config: StemLiteConfig, *,
                            device) -> tuple[dict[str, torch.Tensor], int]:
    """(feature tensors, match-iteration bound) padded to the set's maxima."""
    dags = build_stem_dags(alignments, config, device=device)
    mult = config.node_pad_multiple
    n_pad = max(mult, -(-max(d.n_nodes for d in dags) // mult) * mult)
    iters = max(d.depth for d in dags) + 1
    lmult = config.len_pad_multiple
    lmax = max(lmult, -(-max(a.length for a in alignments) // lmult) * lmult)
    return _pack_stem_features(alignments, dags, config, n_pad, lmax, device), iters


def _bucket_ceil(v: int, mult: int) -> int:
    """Smallest mult * 2^k >= v: geometric buckets bound padding at 2x."""
    b = mult
    while b < v:
        b *= 2
    return b


def featurize_stem_bucketed(alignments: list[Alignment], config: StemLiteConfig, *,
                            device) -> list[tuple[np.ndarray, dict, int]]:
    """Examples grouped by DAG node count: (indices, features, iters) buckets.

    Each bucket is padded to its own geometric node/length bound, so one
    large outlier does not inflate every example's closure tensors.
    Cross-bucket pairs work because every kernel is shape-generic in N_x vs
    N_y and L_x vs L_y.
    """
    dags = build_stem_dags(alignments, config, device=device)
    mult = config.node_pad_multiple
    lmult = config.len_pad_multiple
    groups: dict[int, list[int]] = {}
    for i, d in enumerate(dags):
        groups.setdefault(_bucket_ceil(max(d.n_nodes, 1), mult), []).append(i)
    buckets = []
    for n_pad in sorted(groups):
        idx = np.asarray(groups[n_pad], np.int64)
        alns = [alignments[i] for i in idx]
        dgs = [dags[i] for i in idx]
        lmax = _bucket_ceil(max(a.length for a in alns), lmult)
        iters = max(d.depth for d in dgs) + 1
        buckets.append((idx, _pack_stem_features(alns, dgs, config, n_pad, lmax, device),
                        iters))
    return buckets


def make_stem_lite_kernel_fn(config: StemLiteConfig, iters: int, *, device):
    """Batched kernel_fn(x, y) -> (B,) for the configured composition.

    Mirrors the 4-way kernel selection of stem_kernel_lite/main.cpp:176-215.
    """
    if config.no_ribosum:
        stem = StemKernel(loop_gap=config.loop_gap, beta=None, stack=config.stack,
                          covar=config.covar, len_band=config.len_band,
                          precision=config.precision)
    else:
        stem = StemKernel(loop_gap=config.loop_gap, beta=config.beta,
                          len_band=config.len_band, precision=config.precision)
    stem = stem.to(device)
    string = None
    if not config.no_string:
        if config.no_ribosum:
            string = StringKernel(config.gap, match=config.str_match,
                                  mismatch=config.str_mismatch)
        else:
            string = StringKernel(config.gap, alpha=config.alpha)
        string = string.to(device)

    def kernel_fn(x, y):
        with span("stem"):
            sv = stem(x, y, iters=iters)
        if string is None:
            return combinators.weighted_log(sv, config.beta) if config.use_log else sv
        with span("string"):
            tv = string(x["str_profile"], x["str_length"], y["str_profile"], y["str_length"],
                        x["str_weight"], y["str_weight"])
        if config.use_log:
            return combinators.add(combinators.weighted_log(sv, config.beta),
                                   combinators.weighted_log(tv, config.alpha))
        return combinators.add(sv, tv)

    return kernel_fn
