"""Matrix products of the references, f32 with TF32 off, or with their
operands rounded to TF32 as the tensor cores round them with TF32 on (the
control's products)."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), to nearest, ties away from zero
    (``cvt.rna.tf32.f32``); inf and nan pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def full_f32() -> None:
    """No TF32 in torch's own f32 products (the fold's), on any device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
