"""Stem kernel over structure DAGs as batched matrix products.

Port of ``stem_kernel_tpu/models/stem_kernel.py`` (the DAG convolution of
stem_kernel/stem_kernel_lite/stem_kernel.cpp:14-95).  With per-example dense
operators A (match-path edges), V = (I - B)^{-1} (gap closure),
u = (I - T^T)^{-1} r (root reach) and L = leaf_x leaf_y^T, the recursion is
the fixed point

    G0 = Vx (M Vy^T + L);      M = NS * (Ax G0 Ay^T)

iterated min(depth_x, depth_y) + 1 times per pair, and the kernel value is
u_x^T M u_y plus the leaf-leaf base term.  The fixed point runs in
:func:`..ops.stem_fixed_point.stem_fixed_point`: the hand-written CUDA
kernel for CUDA tensors, and its plain torch version (f32) for CPU tensors.
On the card the precision names map onto product modes, on both of its
routes and at every node count: "highest" f32, "high" 3xTF32, "default"
bf16 (``ops.stem_fixed_point.MODES``).

Node scores are one 16x16 contraction of flattened base-pair profiles plus
rank-1 gap corrections:

    NS = Fx CS Fy^T + nbp_x g2w_y^T + g2w_x nbp_y^T
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.stem_fixed_point import stem_fixed_point
from .ribosum_data import RIBOSUM_P

PRECISIONS = ("highest", "high", "default")


def subst_co_table(beta: float) -> np.ndarray:
    """exp(RIBOSUM_P * beta) flattened to (16, 16) (SubstNodeScore ctor)."""
    return np.exp(RIBOSUM_P * beta).reshape(16, 16).astype(np.float32)


def simple_co_table(match: float, mismatch: float) -> np.ndarray:
    """match/mismatch over base-pair identities (SimpleNodeScore)."""
    t = np.full((16, 16), mismatch, dtype=np.float32)
    np.fill_diagonal(t, match)
    return t


def fixed_point_operands(x: dict, y: dict, co_table: torch.Tensor, *, iters: int,
                         len_band: int = 0) -> tuple[torch.Tensor, ...]:
    """The closure fixed point's arguments for a batch of pairs:
    (NS, Vx, Vy, Ax, Ay, L, ux, uy, per-pair trip counts), contiguous."""
    ns = torch.bmm(torch.matmul(x["bp_freq"], co_table), y["bp_freq"].transpose(1, 2))
    ns = ns + x["nbp_frac"][:, :, None] * y["gap2w"][:, None, :]
    ns = ns + x["gap2w"][:, :, None] * y["nbp_frac"][:, None, :]
    match_ok = ((1.0 - x["leaf"])[:, :, None] * (1.0 - y["leaf"])[:, None, :]
                * x["valid"][:, :, None] * y["valid"][:, None, :])
    if len_band > 0:
        band = (torch.abs(x["length"][:, :, None] - y["length"][:, None, :])
                <= len_band).to(ns.dtype)
        match_ok = match_ok * band
    ns = (ns * match_ok).contiguous()
    leaf_outer = (x["leaf"][:, :, None] * y["leaf"][:, None, :]).contiguous()

    if "depth" in x and "depth" in y:
        itv = torch.minimum(x["depth"], y["depth"]).to(torch.int32) + 1
    else:
        itv = torch.full((ns.shape[0],), iters, dtype=torch.int32, device=ns.device)
    return (ns, x["V"].contiguous(), y["V"].contiguous(), x["A"].contiguous(),
            y["A"].contiguous(), leaf_outer, x["u"].contiguous(), y["u"].contiguous(),
            itv.contiguous())


def stem_kernel_pairs(x: dict, y: dict, co_table: torch.Tensor, *, iters: int,
                      len_band: int = 0, precision: str = "highest") -> torch.Tensor:
    """Batched stem-kernel values (B,) for pairs of DAG feature dicts.

    Feature dicts (from models.dag, stacked with a leading batch axis):
    A (B,N,N), V (B,N,N), u (B,N), r (B,N), leaf (B,N), bp_freq (B,N,16),
    gap2w (B,N), nbp_frac (B,N), length (B,N), valid (B,N), depth (B,).
    ``iters`` bounds every pair's trip count.  ``precision`` picks the
    fixed point's product mode on the card, for every block shape
    ("highest" f32, "high" 3xTF32, "default" bf16); CPU tensors run f32 for
    every name.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    value = stem_fixed_point(
        *fixed_point_operands(x, y, co_table, iters=iters, len_band=len_band),
        max_iters=iters, precision=precision)
    # The leaf-leaf base (K0 = 1) propagates only along the x-side K chain of
    # the reference recursion, so it pairs u_x with the RAW root indicator
    # r_y: value += (u_x . leaf_x) * (r_y . leaf_y).  Nonzero only when a
    # root is itself a leaf (degenerate unstructured input).
    return value + (x["u"] * x["leaf"]).sum(-1) * (y["r"] * y["leaf"]).sum(-1)


class StemKernel(nn.Module):
    """Configured stem kernel (SuStemKernel / SiStemKernel equivalents).

    Defaults mirror the reference CLI (stem_kernel_lite/main.cpp:115-149):
    loop_gap=0.2, beta=0.3 (RIBOSUM) or stack=1.3/covar=0.8 (simple),
    len_band=10 (0 disables).  ``co_table`` (16, 16) overrides both.  The
    table is a buffer, so ``.to(device)`` moves it with the module.
    """

    def __init__(self, *, loop_gap: float = 0.2, beta: float | None = 0.3,
                 stack: float | None = None, covar: float | None = None,
                 len_band: int = 0, precision: str = "highest",
                 co_table: np.ndarray | None = None) -> None:
        super().__init__()
        if co_table is None:
            if beta is not None:
                co_table = subst_co_table(beta)
            elif stack is not None and covar is not None:
                co_table = simple_co_table(stack, covar)
            else:
                raise ValueError("need beta (RIBOSUM) or stack/covar (simple)")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.register_buffer("co_table", torch.tensor(np.asarray(co_table, np.float32)))
        self.loop_gap = loop_gap
        self.len_band = len_band
        self.precision = precision

    def forward(self, x: dict, y: dict, *, iters: int) -> torch.Tensor:
        return stem_kernel_pairs(x, y, self.co_table, iters=iters,
                                 len_band=self.len_band, precision=self.precision)
