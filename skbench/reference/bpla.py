"""The plain reference of ``bpla_kernel -n`` (configuration ``bpla.*``): what
one train job wrote, against the BPLA kernel worked out again from the
job's sequences, at every pair (incl. the diagonal) among ``SAMPLE``
sequences of the job drawn from the check's ``rng``:

- ``gram_gap``: the largest absolute gap of the written normalized Gram,
  exp(L_ij - (L_ii + L_jj)/2) from the reference's log K, normalized in
  float32 as the CLI normalizes;
- ``log_gap``: the largest absolute gap of log K itself, as the timed path
  computed it (``skbench/capture/la_values.py``): the largest relative gap
  of K.  Normalization cancels most of an error common to a row, and the
  family's cross values are small, so the written Gram can hide a fault in
  the LA kernel that log K shows.

The fold runs on every sequence of the job, in the batches the program
folds them in, so that a sequence's pair probabilities are the program's
bit for bit; the profiles, factors and the log-space DP are computed again
per pair (``plain/bpla.py``), each pair in the order (x, y) the program
computed it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..capture import la_values as captured
from ..flows import read_libsvm
from .plain.bpla import (
    DEFAULT_BPLA_SCORE_TABLE, bpla_factors, bpla_features, la_log_factored, log_normalized,
    pad_to, stack_features,
)
from .plain.products import full_f32
from .plain.stem import fold_sequences

SAMPLE = 64  # sequences of the checked job; all pairs among them
BATCH = 256  # pairs a batch of the reference (the program's Gram batch)


def _opt(config: dict, key: str) -> float:
    return float(config["options"][key])


def log_values(feats: list, pairs: list, width: int, config: dict, device,
               tf32: bool) -> np.ndarray:
    """log K (float64, host) of each (a, b) of ``pairs`` of ``feats``, both
    sides padded to ``width``."""
    alpha, beta = _opt(config, "-a"), _opt(config, "-b")
    gap, ext = _opt(config, "-g"), _opt(config, "-e")
    table = torch.as_tensor(DEFAULT_BPLA_SCORE_TABLE, device=device)
    out = np.zeros(len(pairs))
    for lo in range(0, len(pairs), BATCH):
        chunk = pairs[lo:lo + BATCH]
        x = stack_features([feats[a] for a, _ in chunk], width, device)
        y = stack_features([feats[b] for _, b in chunk], width, device)
        with torch.no_grad():
            v = la_log_factored(bpla_factors(x, table, "x"), bpla_factors(y, table, "y"),
                                x["length"], y["length"], alpha, beta, gap, ext, tf32)
        out[lo:lo + len(chunk)] = v.double().cpu().numpy()
    return out


def check(flow: str, job, state, config: dict, rng, device, *, tf32: bool = False) -> dict:
    if flow != "train":
        raise ValueError(f"no bpla reference for the flow {flow!r}")
    full_f32()
    seqs = job.corpus["pos"] + job.corpus["neg"]
    n = len(seqs)
    labels, gram = read_libsvm(job.output)
    want = ["+1"] * len(job.corpus["pos"]) + ["-1"] * len(job.corpus["neg"])
    if labels != want or gram.shape != (n, n):
        raise ValueError(f"train output: {len(labels)} rows of {gram.shape}, want {n} x {n}")
    program = captured.values(job.records)
    sample = np.sort(rng.choice(n, min(SAMPLE, n), replace=False))
    bpps = fold_sequences(seqs, device=device)
    feats = [bpla_features(seqs[i], bpps[i]) for i in sample]
    # each pair in the order the program computed it (x, y)
    pairs = [(a, b) if (sample[a], sample[b]) in program else (b, a)
             for a in range(len(sample)) for b in range(a, len(sample))]
    width = pad_to(max(len(s) for s in seqs))  # the program pads every example alike
    lk = log_values(feats, pairs, width, config, device, tf32)
    diag = {a: v for (a, b), v in zip(pairs, lk) if a == b}
    ref = log_normalized(lk, [diag[a] for a, _ in pairs], [diag[b] for _, b in pairs])
    gram_gap = log_gap = 0.0
    for (a, b), v, r in zip(pairs, lk, ref.astype(np.float64)):
        i, j = int(sample[a]), int(sample[b])
        got = program.get((i, j), float("nan"))
        if not all(np.isfinite((gram[i, j], gram[j, i], got))):
            return {"gram_gap": float("inf"), "log_gap": float("inf")}
        gram_gap = max(gram_gap, abs(gram[i, j] - r), abs(gram[j, i] - r))
        log_gap = max(log_gap, abs(got - v))
    return {"gram_gap": gram_gap, "log_gap": log_gap}
