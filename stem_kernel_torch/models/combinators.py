"""Kernel combinators (stem_kernel/common/conv_kernel.h:12-100 equivalents).

Port of ``stem_kernel_tpu/models/combinators.py``: elementwise functions of
batched (B,) kernel values.

- add(k1, k2)            AddKernel
- weighted_log(k, w)     LTKernel(LogKernel(k), w, 0) = w*log(k), the LSu*
                         variants of def_kernel.h:113-190
"""

from __future__ import annotations

import torch


def add(*values: torch.Tensor) -> torch.Tensor:
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def weighted_log(value: torch.Tensor, w: float) -> torch.Tensor:
    return w * torch.log(value)
