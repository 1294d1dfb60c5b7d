"""Dinucleotide-preserving sequence shuffles (negative-set generation).

Altschul-Erickson Eulerian-path shuffle, the algorithm of
stem_kernel/utils/dishuffle.rb:36-82: build the dinucleotide edge
multigraph, pick a random last-edge tree rooted at the final symbol, verify
connectivity, shuffle the remaining edge orderings, and walk the Eulerian
path.  Preserves exact mono- and di-nucleotide counts.
"""

from __future__ import annotations

import numpy as np


def dinucleotide_shuffle(seq: str, rng: np.random.Generator) -> str:
    """Return a random shuffle of ``seq`` preserving dinucleotide counts,
    drawing from the caller's generator ``rng``."""
    out, _ = dinucleotide_shuffle_indices(list(seq), rng)
    return "".join(out)


def dinucleotide_shuffle_indices(
    tokens: list, rng: np.random.Generator
) -> tuple[list, list[int]]:
    """Eulerian-path shuffle of arbitrary hashable tokens, returning indices.

    Returns (shuffled_tokens, original_positions) like the array form of the
    reference's dishuffle (dishuffle_array, utils/dishuffle.rb:44-82) whose
    index output drives the alignment-column shuffle in dishuffle_aln.rb.
    """
    s = list(tokens)
    if len(s) < 3:
        return s, list(range(len(s)))

    last = s[-1]
    while True:
        # edge lists: for each symbol, the multiset of (successor, position)
        edges: dict = {}
        for i in range(1, len(s)):
            edges.setdefault(s[i - 1], []).append((s[i], i))

        # choose a random "last edge" per non-terminal vertex
        ledge: dict = {}
        for v, succs in edges.items():
            if v == last:
                continue
            i = rng.integers(len(succs))
            ledge[v] = succs.pop(i)

        # check: following last edges from every vertex must reach `last`
        def reaches(v) -> bool:
            seen = set()
            while v != last:
                if v in seen or v not in ledge:
                    return v == last
                seen.add(v)
                v = ledge[v][0]
            return True

        if all(reaches(v) for v in ledge):
            break
        # merge back and retry
        for v, w in ledge.items():
            edges[v].append(w)

    for succs in edges.values():
        rng.shuffle(succs)
    for v, w in ledge.items():
        edges.setdefault(v, []).append(w)  # last edges go last

    out = [s[0]]
    idx = [0]
    cur = s[0]
    while cur in edges and edges[cur]:
        cur, i = edges[cur].pop(0)
        out.append(cur)
        idx.append(i)
    return out, idx
