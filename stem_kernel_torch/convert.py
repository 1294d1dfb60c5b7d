"""Carry the JAX package's tables across to the port.

The "weights" of stem_kernel_lite are its kernel tables and the energy
model; those of the BPLA and protein LA kernels are a substitution table
(4x4, or BLOSUM62) and four hyperparameters.  Every function takes plain
numpy data, so the caller may read it from ``stem_kernel_tpu`` objects
without this package importing it:

    stem_lite_modules_from_numpy(np.asarray(jax_stem.co_table),
                                 np.asarray(jax_string.subst), device)
    energy_params_from_numpy(dataclasses.asdict(jax_default_params()))
    bpla_kernel_from_numpy(np.asarray(jax_bpla.score_table), alpha=jax_bpla.alpha,
                           ..., device=device)
"""

from __future__ import annotations

import numpy as np

from .fold.params import EnergyParams
from .models.bpla import BPLAKernel
from .models.stem_kernel import StemKernel
from .models.string_kernel import StringKernel


def stem_lite_modules_from_numpy(
    co_table: np.ndarray, subst: np.ndarray, device, *, loop_gap: float = 0.2,
    len_band: int = 10, gap: float = 0.8, precision: str = "highest",
) -> tuple[StemKernel, StringKernel]:
    """(StemKernel, StringKernel) on ``device`` holding the given tables:
    ``co_table`` (16, 16) base-pair substitution scores, ``subst`` (4, 4)
    column substitution scores."""
    co = np.asarray(co_table, np.float32)
    sub = np.asarray(subst, np.float32)
    if co.shape != (16, 16) or sub.shape != (4, 4):
        raise ValueError(f"need co_table (16, 16) and subst (4, 4), got {co.shape}, {sub.shape}")
    stem = StemKernel(co_table=co, loop_gap=loop_gap, len_band=len_band,
                      precision=precision).to(device)
    string = StringKernel(gap, subst=sub).to(device)
    return stem, string


def energy_params_from_numpy(d: dict) -> EnergyParams:
    """The port's EnergyParams from a field dict (``dataclasses.asdict``);
    arrays are copied, so the result shares no memory with the source."""
    fields = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            fields[k] = np.array(v, copy=True)
        elif isinstance(v, dict):
            fields[k] = dict(v)
        else:
            fields[k] = v
    return EnergyParams(**fields)


def bpla_kernel_from_numpy(score_table: np.ndarray, *, alpha: float = 4.5,
                           beta: float = 0.11, gap: float = -8.0, ext: float = -0.75,
                           no_bp: bool = False, sw: bool = False, device) -> BPLAKernel:
    """A BPLAKernel on ``device`` holding a copy of ``score_table`` (N, N)."""
    table = np.array(score_table, dtype=np.float32, copy=True)
    if table.ndim != 2 or table.shape[0] != table.shape[1]:
        raise ValueError(f"need a square score table, got shape {table.shape}")
    return BPLAKernel(table, no_bp=no_bp, sw=sw, gap=gap, ext=ext, alpha=alpha,
                      beta=beta).to(device)
