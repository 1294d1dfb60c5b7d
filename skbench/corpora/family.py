"""One hairpin family against its dinucleotide shuffles (Sakakibara, Asai &
Sato 2007: an ncRNA family against shuffled negatives).

Positives: ``per_class`` mutants of one core (a stem, a loop and the stem's
reverse complement, as ``chip_smoke.py:make_family``), each base replaced
by a uniform draw with probability ``mutation``.  Negatives: one
dinucleotide shuffle of each positive.  Job ``j`` takes the family of
length ``core_lengths[j % len(core_lengths)]``, the model set (``job``
None) that of ``model_core_length``.  The cores are drawn from the
configuration's ``core_seed``, not from the run's seed: every seed runs the
same families of the same lengths in the same order, and the seed draws
the mutations and the shuffles (a mix with a ``work_seed`` fixes those
too, ``flows.TrainFlow``).  A family's structure sets its DAG sizes
and with them the work of a job (cores drawn by the seed moved a run's
rate by up to 20% between seeds on the card).
"""

from __future__ import annotations

import numpy as np

from .dishuffle import dinucleotide_shuffle

BASES = np.array(list("acgu"))


def draw_core(rng: np.random.Generator, length: int) -> str:
    stem = rng.integers(0, 4, length // 3)
    loop = rng.integers(0, 4, length - 2 * len(stem))
    # codes a c g u = 0 1 2 3: the complement of code c is 3 - c
    return "".join(BASES[np.concatenate([stem, loop, 3 - stem[::-1]])])


def mutants(rng: np.random.Generator, core: str, n: int, rate: float) -> list[str]:
    codes = np.searchsorted(BASES, np.array(list(core)))
    hit = rng.random((n, len(core))) < rate
    new = np.where(hit, rng.integers(0, 4, (n, len(core))), codes[None, :])
    return ["".join(BASES[row]) for row in new]


def family_core(spec: dict, length: int) -> str:
    """The core of the family of ``length`` nt, drawn from ``core_seed``."""
    return draw_core(np.random.default_rng([int(spec["core_seed"]), length]), length)


def make(spec: dict, rng: np.random.Generator, job: int | None, core: str | None = None) -> dict:
    if core is None:
        lengths = spec["core_lengths"]
        length = spec["model_core_length"] if job is None else lengths[job % len(lengths)]
        core = family_core(spec, int(length))
    pos = mutants(rng, core, int(spec["per_class"]), float(spec["mutation"]))
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    return {"pos": pos, "neg": neg, "core": core}
