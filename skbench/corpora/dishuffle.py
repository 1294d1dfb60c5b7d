"""Dinucleotide-preserving shuffle (Altschul-Erickson Eulerian path).

A frozen copy of ``stem_kernel_torch/utils/shuffle.py`` (the algorithm of
the reference's ``utils/dishuffle.rb:36-82``): the benchmark makes its
negatives itself and imports nothing of the program for it.
"""

from __future__ import annotations

import numpy as np


def dinucleotide_shuffle(seq: str, rng: np.random.Generator) -> str:
    """A random shuffle of ``seq`` with the same mono- and dinucleotide
    counts, drawn from ``rng``."""
    s = list(seq)
    if len(s) < 3:
        return seq
    last = s[-1]
    while True:
        edges: dict = {}
        for i in range(1, len(s)):
            edges.setdefault(s[i - 1], []).append(s[i])
        # a random last edge out of every vertex but the final symbol
        ledge: dict = {}
        for v, succs in edges.items():
            if v != last:
                ledge[v] = succs.pop(int(rng.integers(len(succs))))

        def reaches(v) -> bool:
            seen = set()
            while v != last:
                if v in seen or v not in ledge:
                    return False
                seen.add(v)
                v = ledge[v]
            return True

        if all(reaches(v) for v in ledge):
            break
        for v, w in ledge.items():
            edges[v].append(w)
    for succs in edges.values():
        rng.shuffle(succs)
    for v, w in ledge.items():
        edges.setdefault(v, []).append(w)  # last edges go last
    out = [s[0]]
    cur = s[0]
    while edges.get(cur):
        cur = edges[cur].pop(0)
        out.append(cur)
    return "".join(out)
