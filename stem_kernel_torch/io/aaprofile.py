"""Amino-acid profile sequences (23-letter alphabet).

A numpy copy of ``stem_kernel_tpu/io/aaprofile.py``: column-wise amino-acid
frequency profiles of protein alignments, for the protein LA kernel.
Unknown characters map to X; '-', '.' and '_' are gaps.
"""

from __future__ import annotations

import numpy as np

from ..models.blosum_data import AA_CHARS, N_AA

_AA_CODE = np.full(256, N_AA - 1, dtype=np.uint8)  # default X
for _i, _c in enumerate(AA_CHARS):
    _AA_CODE[ord(_c)] = _i
    _AA_CODE[ord(_c.lower())] = _i
AA_GAP = N_AA
for _g in "-._":
    _AA_CODE[ord(_g)] = AA_GAP


def encode_aa(seq: str) -> np.ndarray:
    return _AA_CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def aa_profile_from_alignment(rows: list[str]) -> np.ndarray:
    """(L, N_AA+1) column counts; slot N_AA is the gap count."""
    L = len(rows[0])
    prof = np.zeros((L, N_AA + 1), dtype=np.float32)
    for row in rows:
        codes = encode_aa(row)
        for i, c in enumerate(codes):
            prof[i, c] += 1.0
    return prof


def aa_features(alignments, *, pad_multiple: int = 8) -> dict[str, np.ndarray]:
    """Padded normalized AA profile tensors for the protein LA kernel."""
    n = len(alignments)
    lmax = max(a.length for a in alignments)
    lmax = max(pad_multiple, -(-lmax // pad_multiple) * pad_multiple)
    prof = np.zeros((n, lmax, N_AA), np.float32)
    lens = np.zeros(n, np.int32)
    for i, a in enumerate(alignments):
        p = aa_profile_from_alignment(a.rows)
        L = p.shape[0]
        base = p[:, :N_AA]
        tot = base.sum(axis=1, keepdims=True)
        prof[i, :L] = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0)
        lens[i] = L
    return {"profile": prof, "length": lens}
