"""The plain reference of ``stem_kernel -b W`` (configuration
``full_stem.*``): the written N x N normalized Gram of one train job, at
every pair (incl. the diagonal) among ``SAMPLE`` sequences of the job drawn
from the check's ``rng``, against exp(L_ij - (L_ii + L_jj)/2) from log K
worked out again by the plain banded engine.  The number compared,
``gram_gap``, is the largest gap relative to the reference's value,
|got - ref| / ref, over the pairs: the full stem kernel's normalized values
span tens of orders of magnitude between sequences of 80 and 300 nt, so an
absolute gap would see only the largest of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flows import read_libsvm
from .plain.banded import full_stem_kernel_banded_log, pair_weights
from .plain.products import full_f32
from .plain.stem import encode

SAMPLE = 16  # sequences of the checked job; all pairs among them
BATCH = 32  # pairs a batch of the reference
TINY = 1e-30  # the gap of a normalized value below this is taken relative to it


def log_k(seqs: list, pairs: list, config: dict, device, tf32: bool) -> np.ndarray:
    """log K (float64, host) of each (a, b) of ``pairs`` of ``seqs``."""
    o = config["options"]
    band, gap, stack, subst = int(o["-b"]), float(o["-g"]), float(o["-s"]), float(o["-v"])
    codes = [encode(s) for s in seqs]
    weights = [pair_weights(c, len(c), min_loop=int(o["-l"])) for c in codes]
    size = [max(len(codes[a]), len(codes[b])) for a, b in pairs]
    order = np.argsort(size, kind="stable")
    out = np.zeros(len(pairs))
    for lo in range(0, len(pairs), BATCH):
        sel = order[lo:lo + BATCH]
        n = max(size[k] for k in sel) + 1
        xc = np.zeros((len(sel), n), np.uint8)
        yc = np.zeros((len(sel), n), np.uint8)
        bx = np.zeros((len(sel), n, n), np.float32)
        by = np.zeros((len(sel), n, n), np.float32)
        lx = np.zeros(len(sel), np.int32)
        ly = np.zeros(len(sel), np.int32)
        for r, k in enumerate(sel):
            a, b = pairs[k]
            la, lb = len(codes[a]), len(codes[b])
            xc[r, :la], yc[r, :lb], lx[r], ly[r] = codes[a], codes[b], la, lb
            bx[r, :la, :la], by[r, :lb, :lb] = weights[a], weights[b]
        t = {k: torch.as_tensor(v, device=device)
             for k, v in dict(xc=xc, yc=yc, lx=lx, ly=ly, bx=bx, by=by).items()}
        with torch.no_grad():
            v = full_stem_kernel_banded_log(t["xc"], t["yc"], t["lx"], t["ly"], t["bx"],
                                            t["by"], gap, stack, subst, band=band, tf32=tf32)
        out[sel] = v.double().cpu().numpy()
    return out


def check(flow: str, job, state, config: dict, rng, device, *, tf32: bool = False) -> dict:
    if flow != "train":
        raise ValueError(f"no full_stem reference for the flow {flow!r}")
    full_f32()
    seqs = job.corpus["pos"] + job.corpus["neg"]
    n = len(seqs)
    labels, gram = read_libsvm(job.output)
    want = ["+1"] * len(job.corpus["pos"]) + ["-1"] * len(job.corpus["neg"])
    if labels != want or gram.shape != (n, n):
        raise ValueError(f"train output: {len(labels)} rows of {gram.shape}, want {n} x {n}")
    sample = np.sort(rng.choice(n, min(SAMPLE, n), replace=False))
    pairs = [(a, b) for a in range(len(sample)) for b in range(a, len(sample))]
    lk = log_k([seqs[i] for i in sample], pairs, config, device, tf32)
    diag = np.array([lk[i] for i, (a, b) in enumerate(pairs) if a == b])
    gap = 0.0
    for (a, b), v in zip(pairs, lk):
        ref = np.exp(v - 0.5 * (diag[a] + diag[b]))
        i, j = sample[a], sample[b]
        for got in (gram[i, j], gram[j, i]):
            if not np.isfinite(got):
                return {"gram_gap": float("inf")}
            gap = max(gap, abs(got - ref) / max(ref, TINY))
    return {"gram_gap": gap}
