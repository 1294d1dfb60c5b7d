"""The plain reference of ``stem_kernel_lite`` (configuration
``stem_lite.*``): what one job wrote, against the kernel worked out again
from the job's sequences.

- ``train``: the written N x N normalized Gram, at every pair (incl. the
  diagonal) among ``TRAIN_SAMPLE`` sequences of the job drawn from the
  check's ``rng``: ``gram_gap``, the largest absolute gap; and the stem
  kernel alone (K1 and its leaf term) at the same pairs, as the timed path
  computed it (``skbench/capture/stem_values.py``): ``stem_gap``, the
  largest gap relative to the reference's value.  The written Gram holds
  stem + string, in which the stem part can be a vanishing share, so only
  ``stem_gap`` holds K1 in every family.
- ``predict``: ``PREDICT_SAMPLE`` test rows of the job drawn from ``rng``:
  ``row_gap``, the largest absolute gap of the written normalized values at
  the support-vector columns (every other column has to be 0), and
  ``decision_gap``, that of the written decision values, each against
  sum_k coef_k K'(t, sv_k) - rho from the model the benchmark wrote.

The fold runs on every sequence of the job, in the batches the program
folds them in, so that a sequence's pair probabilities, and with them its
DAG (a hard threshold on them), are the program's bit for bit; everything
after the fold is computed again per pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..capture import stem_values as captured
from ..flows import read_libsvm, read_predictions
from .plain.products import full_f32
from .plain.stem import fold_sequences, stack_features, stem_features, stem_values, string_values

TRAIN_SAMPLE = 64  # sequences of the checked train job; all pairs among them
PREDICT_SAMPLE = 32  # test rows of the checked predict job
BATCH = 256  # pairs a batch of the reference
NODE_MULTIPLE, LEN_MULTIPLE = 16, 8
TINY = 1e-30  # the gap of a stem value below this is taken relative to it


def _opt(config: dict, key: str) -> float:
    return float(config["options"][key])


def kernel_values(feats: list, pairs: list, config: dict, device, tf32: bool) -> np.ndarray:
    """K(feats[a], feats[b]) (float64, host) for each (a, b) of ``pairs``:
    the stem kernel plus the string kernel, in batches of similar size."""
    return kernel_parts(feats, pairs, config, device, tf32)[0]


def kernel_parts(feats: list, pairs: list, config: dict, device,
                 tf32: bool) -> tuple[np.ndarray, np.ndarray]:
    """(K, the stem kernel alone) (float64, host) for each (a, b) of
    ``pairs``, in batches of similar size."""
    beta, band = _opt(config, "--beta"), int(_opt(config, "--length-band"))
    alpha, gap = _opt(config, "--alpha"), _opt(config, "--gap")
    size = [max(feats[a]["n"], feats[b]["n"]) for a, b in pairs]
    order = np.argsort(size, kind="stable")
    out, stem = np.zeros(len(pairs)), np.zeros(len(pairs))
    for lo in range(0, len(pairs), BATCH):
        sel = order[lo:lo + BATCH]
        xs = [feats[pairs[k][0]] for k in sel]
        ys = [feats[pairs[k][1]] for k in sel]
        n_pad = -(-max(f["n"] for f in xs + ys) // NODE_MULTIPLE) * NODE_MULTIPLE
        l_pad = -(-max(f["str_length"] for f in xs + ys) // LEN_MULTIPLE) * LEN_MULTIPLE
        x = stack_features(xs, n_pad, l_pad, device)
        y = stack_features(ys, n_pad, l_pad, device)
        with torch.no_grad():
            s = stem_values(x, y, beta, band, tf32)
            k = s + string_values(x, y, alpha, gap, tf32)
        out[sel] = k.double().cpu().numpy()
        stem[sel] = s.double().cpu().numpy()
    return out, stem


def _features(seqs: list, bpps: list, which, config: dict) -> dict:
    th, loop_gap = _opt(config, "--basepair"), _opt(config, "--loop-gap")
    return {i: stem_features(seqs[i], bpps[i], th, loop_gap) for i in which}


def check(flow: str, job, state, config: dict, rng, device, *, tf32: bool = False) -> dict:
    full_f32()
    if flow == "train":
        return _check_train(job, config, rng, device, tf32)
    if flow == "predict":
        return _check_predict(job, state, config, rng, device, tf32)
    raise ValueError(f"no stem_lite reference for the flow {flow!r}")


def _check_train(job, config, rng, device, tf32) -> dict:
    seqs = job.corpus["pos"] + job.corpus["neg"]
    n = len(seqs)
    labels, gram = read_libsvm(job.output)
    want = ["+1"] * len(job.corpus["pos"]) + ["-1"] * len(job.corpus["neg"])
    if labels != want or gram.shape != (n, n):
        raise ValueError(f"train output: {len(labels)} rows of {gram.shape}, want {n} x {n}")
    program_stem = captured.values(job.records)
    sample = np.sort(rng.choice(n, min(TRAIN_SAMPLE, n), replace=False))
    feats = _features(seqs, fold_sequences(seqs, device=device), sample, config)
    flist = [feats[i] for i in sample]
    # each pair in the order the program computed it (x, y), where it did
    pairs = [(a, b) if (sample[a], sample[b]) in program_stem else (b, a)
             for a in range(len(sample)) for b in range(a, len(sample))]
    k, stem = kernel_parts(flist, pairs, config, device, tf32)
    diag = np.array([k[i] for i, (a, b) in enumerate(pairs) if a == b])
    gap = stem_gap = 0.0
    for (a, b), v, s in zip(pairs, k, stem):
        ref = v / np.sqrt(diag[a] * diag[b])
        i, j = int(sample[a]), int(sample[b])
        gap = max(gap, abs(gram[i, j] - ref), abs(gram[j, i] - ref))
        if not np.isfinite(gram[i, j]) or not np.isfinite(gram[j, i]):
            gap = float("inf")
        got = program_stem.get((i, j), float("nan"))
        stem_gap = max(stem_gap, abs(got - s) / max(abs(s), TINY))
        if not np.isfinite(got):
            stem_gap = float("inf")
    return {"gram_gap": gap, "stem_gap": stem_gap}


def _check_predict(job, state, config, rng, device, tf32) -> dict:
    train = state.model_corpus["pos"] + state.model_corpus["neg"]
    tests = job.test["pos"] + job.test["neg"]
    n, t = len(train), len(tests)
    labels, rows = read_libsvm(job.output)
    plabels, dec = read_predictions(job.prediction)
    want = ["+1"] * len(job.test["pos"]) + ["-1"] * len(job.test["neg"])
    if labels != want or plabels != want or rows.shape != (t, n) or dec.shape != (t,):
        raise ValueError(f"predict output: {rows.shape} rows, {dec.shape} decision values, "
                         f"want ({t}, {n}) and ({t},)")
    sample = np.sort(rng.choice(t, min(PREDICT_SAMPLE, t), replace=False))
    sv, coef = state.sv_index, np.asarray(state.sv_coef)
    tr_feats = _features(train, fold_sequences(train, device=device), sv, config)
    chunk = int(state.traffic["extra_options"].get("--stream-chunk", 64))
    te_feats = {}
    for lo in sorted({(i // chunk) * chunk for i in sample}):
        part = tests[lo:lo + chunk]
        bpps = fold_sequences(part, device=device)
        mine = [i for i in sample if lo <= i < lo + chunk]
        te_feats.update({i: f for i, f in zip(
            mine, _features(part, bpps, [i - lo for i in mine], config).values())})
    # examples: the sampled tests, then the support vectors
    flist = [te_feats[i] for i in sample] + [tr_feats[j] for j in sv]
    ns = len(sample)
    pairs = ([(a, ns + b) for a in range(ns) for b in range(len(sv))]
             + [(a, a) for a in range(ns)] + [(ns + b, ns + b) for b in range(len(sv))])
    k = kernel_values(flist, pairs, config, device, tf32)
    cross = k[:ns * len(sv)].reshape(ns, len(sv))
    self_t = k[ns * len(sv): ns * len(sv) + ns]
    self_sv = k[ns * len(sv) + ns:]
    ref = cross / np.sqrt(self_t[:, None] * self_sv[None, :])
    got = rows[sample]
    other = np.setdiff1d(np.arange(n), sv)
    row_gap = max(float(np.max(np.abs(got[:, sv] - ref))), float(np.max(np.abs(got[:, other]))))
    dec_ref = ref @ coef - state.rho
    decision_gap = float(np.max(np.abs(dec[sample] - dec_ref)))
    return {"row_gap": row_gap if np.isfinite(row_gap) else float("inf"),
            "decision_gap": decision_gap if np.isfinite(decision_gap) else float("inf")}
