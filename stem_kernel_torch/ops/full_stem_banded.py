"""Banded full stem kernel (K6): CUDA kernel, plain version, wrapper.

Replaces the Pallas TPU kernel
``stem_kernel_tpu/ops/pallas_full_stem.py:full_stem_banded_pallas_log``:
log K of the windowed-memory full stem kernel (semantics in
:func:`..models.full_stem.full_stem_kernel_banded_log`).  The CUDA source is
``stem_kernel_torch/csrc/full_stem_banded.cu``; its header says what bounds
it on the card and what its design does about it.

The wrapper pads both sides to one width, swaps pairs so lx >= ly, computes
the window anchors a (B, n+1) in torch (the scaled staircase, or the PHMM
alignment when ``ali_bound > 0``), sets up the level-0 windows, and runs the
kernel: one launch per level d = 1..max(lx), each over the valid blocks
(i, i+d) of every pair.

Dispatch: a CPU tensor takes :func:`full_stem_banded_log_reference`; a CUDA
tensor launches the kernel or raises.  Nothing falls back.  The counters
(utils.tracing) ``k6.calls`` count the calls that ran the kernel,
``k6.host_syncs`` the wrapper's reads of max(lx), ``k6.levels`` the level
launches.
:func:`_div_scale` runs the kernel's division by a level's scale on its own,
for the checks that hold it to IEEE division.
"""

from __future__ import annotations

import torch

from ..models.full_stem import banded_inputs, banded_level0, full_stem_kernel_banded_log
from ..utils.tracing import count, span
from ._build import load_library

# the CUDA kernel's largest band: two (W, W) f32 planes, W = 2*band+1, in one
# block's shared memory (2 * 169^2 * 4 B = 228,488 B of the H100's 232,448);
# the plain version takes any band
MAX_BAND = 84


def full_stem_banded_log_reference(x_codes, y_codes, lx, ly, bp_x, bp_y, gap, stack,
                                   subst, *, band: int = 16,
                                   ali_bound: float = 0.0) -> torch.Tensor:
    """Plain torch version (the level loop over all blocks)."""
    return full_stem_kernel_banded_log(x_codes, y_codes, lx, ly, bp_x, bp_y, gap, stack,
                                       subst, band=band, ali_bound=ali_bound)


def _check(x_codes, y_codes, lx, ly, bp_x, bp_y, band) -> None:
    if not isinstance(band, int) or isinstance(band, bool) or band < 1:
        raise ValueError(f"band must be a positive int, got {band!r}")
    if not isinstance(x_codes, torch.Tensor) or x_codes.dim() != 2:
        raise ValueError("x_codes must be a (B, nx) tensor")
    if not isinstance(y_codes, torch.Tensor) or y_codes.dim() != 2:
        raise ValueError("y_codes must be a (B, ny) tensor")
    dev = x_codes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"full_stem_banded_log runs on cpu or cuda, not {dev}")
    bsz, nx = x_codes.shape
    ny = y_codes.shape[1]
    want = {"x_codes": (x_codes, (bsz, nx), torch.uint8),
            "y_codes": (y_codes, (bsz, ny), torch.uint8),
            "lx": (lx, (bsz,), torch.int32), "ly": (ly, (bsz,), torch.int32),
            "bp_x": (bp_x, (bsz, nx, nx), torch.float32),
            "bp_y": (bp_y, (bsz, ny, ny), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid limit of 65535 pairs")
    if dev.type == "cuda" and band > MAX_BAND:
        raise ValueError(f"band {band} exceeds the CUDA kernel's limit of {MAX_BAND}: its two "
                         "(2*band+1)^2 f32 planes must fit one block's shared memory")


def full_stem_banded_log(x_codes, y_codes, lx, ly, bp_x, bp_y, gap, stack, subst, *,
                         band: int = 16, ali_bound: float = 0.0) -> torch.Tensor:
    """log K of the banded full stem kernel (K6).  Returns (B,) float32.

    x_codes (B, nx), y_codes (B, ny) uint8; lx, ly (B,) int32; bp_x
    (B, nx, nx), bp_y (B, ny, ny) float32 pair weights; band >= 1 (at most
    ``MAX_BAND`` on the card).
    """
    _check(x_codes, y_codes, lx, ly, bp_x, bp_y, band)
    if x_codes.device.type == "cpu":
        return full_stem_banded_log_reference(x_codes, y_codes, lx, ly, bp_x, bp_y, gap,
                                              stack, subst, band=band, ali_bound=ali_bound)
    dev = x_codes.device
    with span("k6.inputs"):
        x, y, lx, ly, bx, by, a, _ = banded_inputs(x_codes, y_codes, lx, ly, bp_x, bp_y,
                                                   ali_bound)
    bsz, n = x.shape
    W = 2 * band + 1
    out = torch.zeros(bsz, device=dev, dtype=torch.float32)  # block (0, lx) writes log K
    if bsz == 0:
        return out
    with span("k6.sync"):  # the host waits for the device here
        max_lx = int(lx.max())
    count("k6.host_syncs")
    if max_lx == 0:
        return out
    with span("k6.setup"):
        # ping-pong window states, slot = level mod 2 (G0: mod 3, it is read at d-2)
        plane = (bsz, n + 1, W, W)
        k0 = torch.empty((2, *plane), device=dev)
        g0 = torch.empty((3, *plane), device=dev)
        k1 = torch.empty((2, *plane), device=dev)
        g1 = torch.empty((2, *plane), device=dev)
        k0_win, g0_win = banded_level0(gap, band, device=dev)
        k0[0] = k0_win
        g0[0] = g0_win
        g0[2] = 0.0  # level -1
        k1[0] = 0.0
        g1[0] = 0.0
        # scale[b, t+1]: max |K0| of level t (floor 1e-30); levels -1 and 0 are 1
        scale = torch.full((bsz, n + 2), 1e-30, device=dev)
        scale[:, :2] = 1.0
        log_scale = torch.zeros((bsz, n + 1), device=dev)  # logS at each level
        a = a.contiguous()
        with torch.cuda.device(dev):  # the c_float arguments round gap, stack, subst to f32
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = load_library().full_stem_banded_f32(
                x.data_ptr(), y.data_ptr(), bx.data_ptr(), by.data_ptr(), lx.data_ptr(),
                ly.data_ptr(), a.data_ptr(), k0.data_ptr(), g0.data_ptr(), k1.data_ptr(),
                g1.data_ptr(), scale.data_ptr(), log_scale.data_ptr(), out.data_ptr(),
                bsz, n, band, max_lx, float(gap), float(stack), float(subst), stream)
        if rc != 0:
            raise RuntimeError(f"full_stem_banded kernel launch failed: CUDA error {rc}")
    count("k6.calls")
    count("k6.levels", max_lx)
    return out  # a pair with lx = 0 is never visited: log K = 0


def _div_scale(x: torch.Tensor, m: float) -> torch.Tensor:
    """x / m by the kernel's division of a level's scale (CUDA f32 only)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = load_library().full_stem_div_scale_f32(
            x.data_ptr(), x.numel(), float(m), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"full_stem_div_scale launch failed: CUDA error {rc}")
    return out

