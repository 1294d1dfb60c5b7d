"""Base-pair probabilities: energy model, LUTs, the scaled and exact
McCaskill engines, alifold, SFOLD sampling and the CONTRAfold model."""

from .params import EnergyParams, default_params
from .mccaskill import mccaskill_logZ, mccaskill_bpp, mccaskill_bpp_batch
from .bpmatrix import (
    BPMatrixOptions,
    fold_sequences,
    average_bpp,
    bpp_for_alignment,
    bpp_for_alignments,
    alifold_bpp,
)
from .contrafold import (
    contrafold_bpp,
    contrafold_energy_params,
    load_contrafold_params,
    train_contrafold,
)

__all__ = [
    "contrafold_bpp",
    "contrafold_energy_params",
    "load_contrafold_params",
    "train_contrafold",
    "EnergyParams",
    "default_params",
    "mccaskill_logZ",
    "mccaskill_bpp",
    "mccaskill_bpp_batch",
    "BPMatrixOptions",
    "fold_sequences",
    "average_bpp",
    "bpp_for_alignment",
    "bpp_for_alignments",
    "alifold_bpp",
]
