"""Stochastic structure sampling (SFOLD) by traceback through inside tables.

Port of ``stem_kernel_tpu/fold/sampling.py``, the reference's SFOLD method
— Vienna ``pbacktrack`` sampling with pair counting
(stem_kernel/common/bpmatrix.cpp:179-232): draw Boltzmann-distributed
secondary structures and estimate the BPP matrix as pair frequencies over
``n_samples`` draws.

The inside tables come from the exact log-space pass (fold.mccaskill) in
float64 on the named device and move to the host once; the traceback is
numpy under ``np.random.default_rng(seed)``, as in the JAX package, and
mirrors the inside decomposition exactly, so samples are exact (no
approximation beyond Monte Carlo error).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.alphabet import encode
from .mccaskill import _inside, _luts, _Offsets
from .mccaskill_scaled import _interior_offsets
from .params import EnergyParams, default_params

# explicit small-loop lut terms: (name, inner span offset, inner start shift)
_EXPLICIT = (
    ("bulge1_l", 3, 2), ("bulge1_r", 3, 1),
    ("int11", 4, 2),
    ("int21_l", 5, 2), ("int21_r", 5, 3),
    ("int22", 6, 3),
)
_CLS_OUT = ("mm_i_out", "mm_1n_out", "mm_23_out", "term_out")
_CLS_IN = ("mm_i_in", "mm_1n_in", "mm_23_in", "term_in")


def _softmax_choice(rng: np.random.Generator, logw: np.ndarray) -> int:
    m = logw.max()
    p = np.exp(logw - m)
    p = p / p.sum()
    return int(rng.choice(len(logw), p=p))


class _Sampler:
    def __init__(self, codes: np.ndarray, params: EnergyParams, device):
        self.params = params
        n = len(codes)
        self.n = n
        c = torch.as_tensor(np.asarray(codes, np.int64), device=device)
        L = _luts(c, n, params, None, None, torch.float64)
        with torch.no_grad():
            Qb, _, Qm1, Qm, Qm2, ql, logZ = _inside(
                c, n, params, L, _Offsets(params, torch.float64, device))
        # the traceback's only device-to-host move
        host = [t.cpu().numpy() for t in (Qb, Qm1, Qm, Qm2, ql)]
        self.Qb, self.Qm1, self.Qm, self.Qm2, self.ql = host  # span layout [d, i]
        self.logZ = float(logZ)
        self.ia, self.ib, self.ipen, self.icls = _interior_offsets(params)
        self.L = {k: v.cpu().numpy() for k, v in L.items()}

    def qb(self, i, j):
        return self.Qb[j - i, i] if 0 <= j - i < self.n else -1e30

    def sample(self, rng: np.random.Generator) -> list[tuple[int, int]]:
        pairs: list[tuple[int, int]] = []
        self._sample_exterior(rng, self.n - 1, pairs)
        return pairs

    def _sample_exterior(self, rng, j, pairs):
        # Ql[j] = Ql[j-1] ⊕ (+)_k Ql[k-1] + Qb[k, j] + ext_stem[k, j]
        while j >= 0:
            # j unpaired -> continue at j-1 (+ per-base exterior score)
            opts = [self.ql[j] + self.params.ext_unpaired]
            ks = []
            for k in range(0, j - 3):
                w = self.ql[k] + self.qb(k, j) + self.L["ext_stem"][k, j]
                if w > -1e29:
                    opts.append(w)
                    ks.append(k)
            c = _softmax_choice(rng, np.asarray(opts))
            if c == 0:
                j -= 1
            else:
                k = ks[c - 1]
                self._sample_pair(rng, k, j, pairs)
                j = k - 1

    def _sample_pair(self, rng, i, j, pairs):
        pairs.append((i, j))
        d = j - i
        L = self.L
        opts = []
        acts = []
        # hairpin (full lut incl. mismatch/terminal/specials/gates)
        if L["hairpin"][i, j] > -1e29:
            opts.append(float(L["hairpin"][i, j]))
            acts.append(("hp",))
        # stack
        w = L["stack"][i, j] + self.qb(i + 1, j - 1)
        if w > -1e29:
            opts.append(w)
            acts.append(("il", i + 1, j - 1))
        # explicit small loops (bulge-1, int11, int21, int22)
        for name, ds, sh in _EXPLICIT:
            k, l = i + sh, j - (ds - sh)
            w = L[name][i, j] + self.qb(k, l)
            if w > -1e29:
                opts.append(w)
                acts.append(("il", k, l))
        # loop-class offsets (generic / 1xn / 2x3 / bulges >= 2)
        for a, b, pen, cls in zip(self.ia, self.ib, self.ipen, self.icls):
            k, l = i + int(a), j - int(b)
            if k < l:
                w = (pen + L[_CLS_OUT[cls]][i, j]
                     + L[_CLS_IN[cls]][k, l] + self.qb(k, l))
                if w > -1e29:
                    opts.append(w)
                    acts.append(("il", k, l))
        # multiloop (close lut includes a + b + terminal + mismatch + gate)
        if d - 2 >= 0:
            w = L["ml_close"][i, j] + (
                self.Qm2[d - 2, i + 1] if d - 2 < self.n else -1e30
            )
            if w > -1e29:
                opts.append(w)
                acts.append(("ml", i + 1, j - 1))
        act = acts[_softmax_choice(rng, np.asarray(opts))]
        if act[0] == "il":
            self._sample_pair(rng, act[1], act[2], pairs)
        elif act[0] == "ml":
            self._sample_qm2(rng, act[1], act[2], pairs)

    def _sample_qm2(self, rng, i, j, pairs):
        # Qm2[i,j] = (+)_t Qm[i, i+t-1] + Qm1[i+t, j]
        opts, ks = [], []
        for t in range(1, j - i + 1):
            w = (
                (self.Qm[t - 1, i] if t - 1 < self.n else -1e30)
                + (self.Qm1[j - (i + t), i + t] if 0 <= j - (i + t) < self.n else -1e30)
            )
            if w > -1e29:
                opts.append(w)
                ks.append(i + t)
        k = ks[_softmax_choice(rng, np.asarray(opts))]
        self._sample_qm(rng, i, k - 1, pairs)
        self._sample_qm1(rng, k, j, pairs)

    def _sample_qm(self, rng, i, j, pairs):
        # Qm[i,j] = Qm2[i,j] ⊕ (+)_t c*t + Qm1[i+t, j]
        c = self.params.ml_unpaired
        opts = [self.Qm2[j - i, i] if 0 <= j - i < self.n else -1e30]
        acts = [("qm2",)]
        for t in range(0, j - i + 1):
            w = c * t + (self.Qm1[j - (i + t), i + t] if 0 <= j - (i + t) < self.n else -1e30)
            if w > -1e29:
                opts.append(w)
                acts.append(("qm1", i + t))
        act = acts[_softmax_choice(rng, np.asarray(opts))]
        if act[0] == "qm2":
            self._sample_qm2(rng, i, j, pairs)
        else:
            self._sample_qm1(rng, act[1], j, pairs)

    def _sample_qm1(self, rng, k, j, pairs):
        # Qm1[k,j] = (+)_l ml_stem[k,l] + Qb[k,l] + c*(j-l)
        c = self.params.ml_unpaired
        opts, ls = [], []
        for l in range(k + 1, j + 1):
            w = self.qb(k, l) + self.L["ml_stem"][k, l] + c * (j - l)
            if w > -1e29:
                opts.append(w)
                ls.append(l)
        l = ls[_softmax_choice(rng, np.asarray(opts))]
        self._sample_pair(rng, k, l, pairs)


def sample_structures(
    seq: str,
    n_samples: int,
    params: EnergyParams | None = None,
    seed: int = 0,
    *,
    device,
) -> list[list[tuple[int, int]]]:
    """Draw Boltzmann samples of secondary structures (lists of pairs); the
    inside pass runs on ``device``."""
    params = params or default_params()
    sampler = _Sampler(encode(seq), params, device)
    rng = np.random.default_rng(seed)
    return [sampler.sample(rng) for _ in range(n_samples)]


def sfold_bpp(
    seq: str,
    n_samples: int = 100,
    params: EnergyParams | None = None,
    seed: int = 0,
    *,
    device,
) -> np.ndarray:
    """BPP matrix from pair counts over samples (bpmatrix.cpp:199-232)."""
    L = len(seq)
    bpp = np.zeros((L, L))
    for pairs in sample_structures(seq, n_samples, params, seed, device=device):
        for (i, j) in pairs:
            bpp[i, j] += 1.0
    return bpp / n_samples
