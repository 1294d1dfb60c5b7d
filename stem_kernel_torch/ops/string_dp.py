"""Gap-weighted string kernel DP on the card: the CUDA kernel's wrappers.

The kernel (``stem_kernel_torch/csrc/string_dp.cu``) replaces no Pallas
kernel: the JAX package runs this DP as a ``lax.scan``.  It runs the whole
DP of every pair of a call in one launch, one warp a pair; its header says
what bounds it and what its design does about that.  Two score sources:

- :func:`string_dp_profile` builds each cell's score in the kernel from the
  profiles, the 4 x 4 substitution table, the position weights and the
  lengths (``StringKernel``'s scores, no (B, Lx, Ly) tensor);
- :func:`string_dp_scores` reads a given (B, Lx, Ly) score tensor, zero
  outside each pair's lengths (:func:`..models.string_kernel.exact_match_scores`).

Both take CUDA tensors only and launch the kernel or raise; the plain
versions, which CPU tensors take, are in :mod:`..models.string_kernel`,
which routes by device.  No autograd: an input that requires grad raises.
Each launch counts ``string.calls.kernel`` and its pairs
``string.pairs.kernel`` (utils.tracing).
"""

from __future__ import annotations

import torch

from ..utils.tracing import count
from ._build import load_library

MAX_LY = 29056  # columns: 8 bytes a column of one block's shared memory (csrc/string_dp.cu)
ALPHABET = 4  # profile columns (N_RNA)


def _check_tensor(name: str, t, shape: tuple, dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor")
    if t.requires_grad:
        raise ValueError(f"{name}: the string DP kernel has no backward; the input requires grad")


def _check_device(tensors: dict, max_ly: int) -> torch.device:
    if max_ly > MAX_LY:
        raise ValueError(f"Ly = {max_ly} exceeds the string DP kernel's limit of {MAX_LY} columns")
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the string DP kernel runs on cuda, not {dev}; CPU tensors take "
                         "the plain row loop of models.string_kernel")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, not {dev}")
    return dev


def _launch(entry: str, ptrs: list, dims: list, gap: float, dev) -> torch.Tensor:
    bsz = dims[0]
    out = torch.empty(bsz, device=dev, dtype=torch.float32)
    if bsz == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load_library(), entry)(*ptrs, *dims, float(gap), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    count("string.calls.kernel")
    count("string.pairs.kernel", bsz)
    return out


def string_dp_profile(px, py, subst, wx, wy, lx, ly, gap: float) -> torch.Tensor:
    """K0[lx][ly] (B,) float32 of the profile string kernel.

    px (B, Lx, 4), py (B, Ly, 4), subst (4, 4), wx (B, Lx), wy (B, Ly)
    float32; lx, ly (B,) int32 (a length past its axis counts as the axis).
    """
    if not isinstance(px, torch.Tensor) or px.dim() != 3:
        raise ValueError(f"px must be a (B, Lx, {ALPHABET}) tensor")
    if not isinstance(py, torch.Tensor) or py.dim() != 3:
        raise ValueError(f"py must be a (B, Ly, {ALPHABET}) tensor")
    bsz, max_lx, max_ly = px.shape[0], px.shape[1], py.shape[1]
    tensors = {"px": (px, (bsz, max_lx, ALPHABET), torch.float32),
               "py": (py, (bsz, max_ly, ALPHABET), torch.float32),
               "subst": (subst, (ALPHABET, ALPHABET), torch.float32),
               "wx": (wx, (bsz, max_lx), torch.float32),
               "wy": (wy, (bsz, max_ly), torch.float32),
               "lx": (lx, (bsz,), torch.int32), "ly": (ly, (bsz,), torch.int32)}
    for name, (t, shape, dtype) in tensors.items():
        _check_tensor(name, t, shape, dtype)
    dev = _check_device({name: t for name, (t, _, _) in tensors.items()}, max_ly)
    return _launch("string_dp_profile_f32", [t.data_ptr() for t, _, _ in tensors.values()],
                   [bsz, max_lx, max_ly], gap, dev)


def string_dp_scores(scores, gap: float) -> torch.Tensor:
    """K0[Lx][Ly] (B,) float32 of a (B, Lx, Ly) float32 score tensor that is
    zero outside each pair's lengths."""
    if not isinstance(scores, torch.Tensor) or scores.dim() != 3:
        raise ValueError("scores must be a (B, Lx, Ly) tensor")
    _check_tensor("scores", scores, tuple(scores.shape), torch.float32)
    dev = _check_device({"scores": scores}, scores.shape[2])
    return _launch("string_dp_scores_f32", [scores.data_ptr()], list(scores.shape), gap, dev)
