"""IUPAC RNA alphabet and byte encoding.

Equivalent of the reference's RNA data model
(stem_kernel/common/rna.h:12-35, stem_kernel/common/rna.cpp:14-96):
a 16-code IUPAC alphabet with A/C/G/U(T) as codes 0..3, GAP as 4, and the
ambiguity codes 5..15.  Fractional IUPAC->ACGU weights follow
stem_kernel/common/profile.cpp:10-29 (iupac_weight): each ambiguity code
distributes one unit of count uniformly over its compatible bases.

Sequences are encoded as numpy uint8 arrays so whole batches can be moved to
device and one-hot expanded with a single table lookup.
"""

from __future__ import annotations

import numpy as np

# Code points (match the reference enum in common/rna.h:12-32 so that encoded
# data and score tables can be compared index-for-index).
RNA_A = 0
RNA_C = 1
RNA_G = 2
RNA_T = 3
RNA_U = 3
N_RNA = 4
RNA_GAP = 4
RNA_R = 5
RNA_Y = 6
RNA_M = 7
RNA_K = 8
RNA_S = 9
RNA_W = 10
RNA_B = 11
RNA_D = 12
RNA_H = 13
RNA_V = 14
RNA_N = 15
N_IUPAC = 16

GAP_CHAR = "-"

_CODE_TO_CHAR = np.array(list("acgu-rymkswbdhvn"))

# char -> code lookup over the full byte range; unknown characters map to N
# (the reference maps unknowns to RNA_N via its default branch,
# common/rna.cpp:63-94).
_CHAR_TO_CODE = np.full(256, RNA_N, dtype=np.uint8)
for _i, _c in enumerate("acgu-rymkswbdhvn"):
    _CHAR_TO_CODE[ord(_c)] = _i
    _CHAR_TO_CODE[ord(_c.upper())] = _i
_CHAR_TO_CODE[ord("t")] = RNA_T
_CHAR_TO_CODE[ord("T")] = RNA_T
_CHAR_TO_CODE[ord(".")] = RNA_GAP
_CHAR_TO_CODE[ord("_")] = RNA_GAP

# Fractional base weights per IUPAC code (common/profile.cpp:10-29).
IUPAC_WEIGHT = np.zeros((N_IUPAC, N_RNA), dtype=np.float32)
IUPAC_WEIGHT[RNA_A, RNA_A] = 1.0
IUPAC_WEIGHT[RNA_C, RNA_C] = 1.0
IUPAC_WEIGHT[RNA_G, RNA_G] = 1.0
IUPAC_WEIGHT[RNA_T, RNA_T] = 1.0
for _code, _bases in {
    RNA_R: (RNA_A, RNA_G),
    RNA_Y: (RNA_C, RNA_T),
    RNA_M: (RNA_A, RNA_C),
    RNA_K: (RNA_G, RNA_T),
    RNA_S: (RNA_C, RNA_G),
    RNA_W: (RNA_A, RNA_T),
    RNA_B: (RNA_C, RNA_G, RNA_T),
    RNA_D: (RNA_A, RNA_G, RNA_T),
    RNA_H: (RNA_A, RNA_C, RNA_T),
    RNA_V: (RNA_A, RNA_C, RNA_G),
    RNA_N: (RNA_A, RNA_C, RNA_G, RNA_T),
}.items():
    for _b in _bases:
        IUPAC_WEIGHT[_code, _b] = 1.0 / len(_bases)


def encode(seq: str) -> np.ndarray:
    """Encode an RNA/DNA string (possibly gapped) to uint8 IUPAC codes."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def decode(codes: np.ndarray) -> str:
    """Inverse of :func:`encode` (lower-case, 'u' for code 3)."""
    return "".join(_CODE_TO_CHAR[np.asarray(codes, dtype=np.int64)])


def erase_gap(seq: str) -> str:
    """Remove gap characters from a string (common/rna.cpp erase_gap)."""
    return "".join(c for c in seq if c not in "-._")
