"""One-command proof that the PyTorch port runs its main path on one GPU.

    python3 chip_smoke.py

Phases (the first failure exits non-zero; nothing is caught):

1. environment: the card's name and power limit (nvidia-smi), CUDA, TF32 off;
2. build: the CUDA library from ``stem_kernel_torch/csrc``;
3. kernel parity: the closure fixed point kernel against its plain torch
   version on real DAG features of the corpus (B=256 pairs within the
   largest node bucket, and B=256 pairs across it and the next largest, as
   the Gram's cross-bucket blocks run; true per-pair trip counts), rel 1e-4;
4. main path: ``stem_kernel_lite`` train on 100 hairpin-family sequences and
   100 dinucleotide shuffles (length 120, fixed seed), ``svm_tools train``,
   then the predict flow on 40 held-out sequences; the kernel's launch count
   must rise, the Gram must be finite, symmetric with unit diagonal, the
   predictions written; a small subset is rerun with ``--device cpu`` (the
   plain versions): the two Grams must agree within the 1.4e-2 CLI band and
   the two folds within 5e-4 BPP;
5. times with CUDA events / synchronized host clocks.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_TRAIN = 100  # per class
N_TEST = 20  # per class
SEQ_LEN = 120
KERNEL_RTOL = 1e-4
CLI_BAND = 1.4e-2  # port-vs-plain Gram band (fold f32 deltas through the DAG)
BPP_BAND = 5e-4  # f32 fold against f32 fold (tests/test_fold_goldens.py)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_family(rng: np.random.Generator, n: int, length: int) -> list[str]:
    """Hairpin family: one stem/loop/reverse-complement core, 10% mutations."""
    stem = "".join(rng.choice(list("acgu"), size=length // 3))
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    rc = "".join(comp[c] for c in reversed(stem))
    core = stem + "".join(rng.choice(list("acgu"), size=length - 2 * len(stem))) + rc
    out = []
    for _ in range(n):
        s = list(core)
        for i in range(len(s)):
            if rng.random() < 0.1:
                s[i] = rng.choice(list("acgu"))
        out.append("".join(s))
    return out


def write_fasta(path: str, seqs: list[str], prefix: str) -> str:
    with open(path, "w") as f:
        f.write("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))
    return path


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from stem_kernel_torch.cli import stem_kernel_lite, svm_tools
    from stem_kernel_torch.fold.bpmatrix import fold_sequences
    from stem_kernel_torch.gram.bucketed import bucketed_gram
    from stem_kernel_torch.gram.io import read_precomputed
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.composite import (
        StemLiteConfig, featurize_stem_bucketed, make_stem_lite_kernel_fn,
    )
    from stem_kernel_torch.models.stem_kernel import fixed_point_operands, subst_co_table
    from stem_kernel_torch.ops._build import build
    from stem_kernel_torch.ops.stem_fixed_point import (
        stem_fixed_point, stem_fixed_point_reference,
    )
    from stem_kernel_torch.utils.roc import roc_curve_and_auc
    from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

    # ---- 1. environment ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # ---- 2. build ----
    _, build_s = build()
    print(f"build: {build_s:.1f} s")

    # ---- data ----
    rng = np.random.default_rng(SEED)
    fam = make_family(rng, N_TRAIN + N_TEST, SEQ_LEN)
    shuf = [dinucleotide_shuffle(s, rng) for s in fam]
    pos, tpos = fam[:N_TRAIN], fam[N_TRAIN:]
    neg, tneg = shuf[:N_TRAIN], shuf[N_TRAIN:]
    train = pos + neg

    # ---- 3. kernel parity at the main path's shapes ----
    # the largest node bucket against itself (square), and against the
    # next largest (Nx != Ny, as the Gram's cross-bucket blocks run it)
    cfg = StemLiteConfig()
    buckets = featurize_stem_bucketed([Alignment(rows=[s]) for s in train], cfg, device=dev)
    by_size = sorted(buckets, key=lambda b: len(b[0]), reverse=True)
    co = torch.as_tensor(subst_co_table(cfg.beta), device=dev)
    pair_rng = np.random.default_rng(SEED + 1)
    cases = []
    for (idx_x, fx, it_x), (idx_y, fy, it_y) in [(by_size[0], by_size[0])] + (
            [(by_size[0], by_size[1])] if len(by_size) > 1 else []):
        bix = torch.as_tensor(pair_rng.integers(0, len(idx_x), 256), device=dev)
        biy = torch.as_tensor(pair_rng.integers(0, len(idx_y), 256), device=dev)
        x = {k: v.index_select(0, bix) for k, v in fx.items()}
        y = {k: v.index_select(0, biy) for k, v in fy.items()}
        iters = max(it_x, it_y)
        cases.append((fixed_point_operands(x, y, co, iters=iters, len_band=cfg.len_band),
                      iters))
    max_abs = 0.0
    for case_args, case_iters in cases:
        got = stem_fixed_point(*case_args, max_iters=case_iters)
        want = stem_fixed_point_reference(*case_args, max_iters=case_iters)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel output not finite")
        err = (got - want).abs()
        rel = float((err / (want.abs() + 1e-6 * want.abs().max())).max())
        max_abs = max(max_abs, float(err.max()))
        _, nx, ny = case_args[0].shape
        print(f"K1 parity: B=256 Nx={nx} Ny={ny} max_iters={case_iters} trip counts "
              f"{int(case_args[-1].min())}..{int(case_args[-1].max())}: max abs "
              f"{float(err.max()):.3e} max rel {rel:.3e} (limit {KERNEL_RTOL})")
        check(rel <= KERNEL_RTOL, f"kernel disagrees with its plain version: rel {rel}")
    args, iters = cases[0]
    n_nodes = args[0].shape[1]

    # ---- 4. main path ----
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda f: os.path.join(tmp, f)  # noqa: E731
        write_fasta(p("pos.fa"), pos, "p")
        write_fasta(p("neg.fa"), neg, "n")
        write_fasta(p("tpos.fa"), tpos, "tp")
        write_fasta(p("tneg.fa"), tneg, "tn")
        stem_fixed_point.launches = 0
        t0 = time.perf_counter()
        stem_kernel_lite.main(["--device", "cuda", "-n", p("km.dat"),
                               "+1", p("pos.fa"), "-1", p("neg.fa")])
        train_s = time.perf_counter() - t0
        train_launches = stem_fixed_point.launches
        svm_tools.train_main([p("km.dat"), p("km.model")])
        t0 = time.perf_counter()
        stem_kernel_lite.main(["--device", "cuda", "-n", p("test.dat"),
                               "--model", p("km.model"), "--predict", p("pred.txt"),
                               "+1", p("pos.fa"), "-1", p("neg.fa"),
                               "--test", "+1", p("tpos.fa"), "-1", p("tneg.fa")])
        predict_s = time.perf_counter() - t0
        launches = stem_fixed_point.launches
        labels, g = read_precomputed(p("km.dat"))
        pred_lines = open(p("pred.txt")).read().splitlines()

        # small-input reference: the same flow on the plain versions (CPU)
        write_fasta(p("spos.fa"), pos[:4], "p")
        write_fasta(p("sneg.fa"), neg[:4], "n")
        for d in ("cuda", "cpu"):
            stem_kernel_lite.main(["--device", d, "-n", p(f"small_{d}.dat"),
                                   "+1", p("spos.fa"), "-1", p("sneg.fa")])
        _, g_cuda = read_precomputed(p("small_cuda.dat"))
        _, g_cpu = read_precomputed(p("small_cpu.dat"))
    # the fold's f32 scaled engine on the card against the CPU (denormals:
    # the log-table floor TINY = 1e-38 lies below the smallest normal f32)
    small = pos[:4] + neg[:4]
    bpp_diff = max(float(np.abs(a - b).max()) for a, b in zip(
        fold_sequences(small, cfg.bp_opts, device=dev),
        fold_sequences(small, cfg.bp_opts, device="cpu")))

    n = 2 * N_TRAIN
    print(f"main path: train Gram {g.shape}, {n * (n + 1) // 2} pairs, K1 launches "
          f"{train_launches} (train) {launches} (train + predict)")
    check(launches > 0 and train_launches > 0, "the main path never launched K1")
    check(g.shape == (n, n) and labels == ["+1"] * N_TRAIN + ["-1"] * N_TRAIN,
          f"Gram shape {g.shape}")
    check(bool(np.isfinite(g).all()), "Gram not finite")
    check(float(np.abs(g - g.T).max()) <= 1e-6, "Gram not symmetric")
    check(float(np.abs(np.diag(g) - 1.0).max()) <= 1e-5, "Gram diagonal is not 1")
    check(len(pred_lines) == 2 * N_TEST, f"{len(pred_lines)} prediction lines")
    y_true = np.array([1.0 if ln.split()[0] == "+1" else -1.0 for ln in pred_lines])
    dec = np.array([float(ln.split()[1]) for ln in pred_lines])
    check(bool(np.isfinite(dec).all()), "decision values not finite")
    auc, _ = roc_curve_and_auc(y_true, dec)
    small_diff = float(np.abs(g_cuda - g_cpu).max())
    print(f"predict: {len(pred_lines)} rows, AUC {auc:.4f}; small-input cuda vs cpu: "
          f"Gram max abs diff {small_diff:.3e} (band {CLI_BAND}), BPP max abs diff "
          f"{bpp_diff:.3e} (band {BPP_BAND})")
    check(small_diff <= CLI_BAND, "cuda and cpu Grams disagree on the small input")
    check(bpp_diff <= BPP_BAND, "cuda and cpu folds disagree on the small input")

    # ---- 5. times ----
    for _ in range(2):
        stem_fixed_point(*args, max_iters=iters)
        stem_fixed_point_reference(*args, max_iters=iters)
    plain_a = cuda_ms(lambda: stem_fixed_point_reference(*args, max_iters=iters), 5)
    kern_a = cuda_ms(lambda: stem_fixed_point(*args, max_iters=iters), 5)
    kern_b = cuda_ms(lambda: stem_fixed_point(*args, max_iters=iters), 5)
    plain_b = cuda_ms(lambda: stem_fixed_point_reference(*args, max_iters=iters), 5)
    k_ms, p_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold_sequences(train, cfg.bp_opts, device=dev)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bucketed_gram(buckets, lambda it: make_stem_lite_kernel_fn(cfg, it, device=dev),
                  device=dev, normalize=True)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    n_pairs = n * (n + 1) // 2
    print(f"times on {smi}: K1 {k_ms:.3f} ms vs plain {p_ms:.3f} ms "
          f"(B=256 N={n_nodes} max_iters={iters}); fold {len(train) / fold_s:.1f} seqs/s; "
          f"Gram {n_pairs / gram_s:.1f} pairs/s ({gram_s:.2f} s); train flow {train_s:.2f} s; "
          f"predict flow {2 * N_TEST / predict_s:.2f} rows/s ({predict_s:.2f} s)")

    print(json.dumps({"kernels": [{
        "name": "stem_fixed_point", "route": "cuda",
        "source": "stem_kernel_torch/csrc/stem_fixed_point.cu",
        "replaces": "stem_kernel_tpu/ops/pallas_stem.py:119",
        "launches": launches, "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
