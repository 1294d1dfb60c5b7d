"""Stem-kernel closure fixed point: CUDA kernel, plain version, wrapper.

Per pair b, starting from M = 0, repeat ``iters[b]`` times (capped at
``max_iters``)

    G = Vx (M Vy^T + L);      M = NS * (Ax G Ay^T)

and return ux^T M uy, shape (B,).  This replaces the Pallas TPU kernel
``stem_kernel_tpu/ops/pallas_stem.py:stem_fixed_point``; the CUDA source is
``stem_kernel_torch/csrc/stem_fixed_point.cu``, whose header says what bounds
it on the card and what its design does about it.

Dispatch: a CPU tensor takes :func:`stem_fixed_point_reference`; a CUDA
tensor launches the kernel or raises.  Nothing falls back.

Precision: every precision name ("highest", "high", "default") runs full
f32 FFMA on the card in this version.  The names stay accepted so the CLI
grammar matches the JAX package; mapping "high"/"default" onto 3xTF32, TF32
or bf16 with measured error is later work.
"""

from __future__ import annotations

import torch

from ._build import load_library


def stem_fixed_point_reference(ns, vx, vy, ax, ay, l, ux, uy, iters, *,
                               max_iters: int) -> torch.Tensor:
    """Plain torch version: a ``bmm`` loop in f32 with a per-pair mask."""
    it = torch.clamp(iters, max=max_iters)
    vyt = vy.transpose(1, 2)
    ayt = ay.transpose(1, 2)
    m = torch.zeros_like(ns)
    for k in range(max_iters):
        g = torch.bmm(vx, torch.bmm(m, vyt) + l)
        m_new = ns * torch.bmm(ax, torch.bmm(g, ayt))
        m = torch.where((it > k)[:, None, None], m_new, m)
    return torch.einsum("bi,bij,bj->b", ux, m, uy)


def _check(ns, vx, vy, ax, ay, l, ux, uy, iters) -> tuple[int, int, int]:
    """Validate operand devices, dtypes, shapes and layout; (B, Nx, Ny)."""
    if ns.dim() != 3:
        raise ValueError(f"ns must be (B, Nx, Ny), got {tuple(ns.shape)}")
    bsz, nx, ny = ns.shape
    dev = ns.device
    want = {"ns": (bsz, nx, ny), "vx": (bsz, nx, nx), "vy": (bsz, ny, ny),
            "ax": (bsz, nx, nx), "ay": (bsz, ny, ny), "l": (bsz, nx, ny),
            "ux": (bsz, nx), "uy": (bsz, ny)}
    for name, t in zip(want, (ns, vx, vy, ax, ay, l, ux, uy)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: need shape {want[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
    if (iters.device != dev or iters.dtype != torch.int32
            or tuple(iters.shape) != (bsz,) or not iters.is_contiguous()):
        raise ValueError(
            f"iters: need contiguous int32 ({bsz},) on {dev}, got "
            f"{iters.dtype} {tuple(iters.shape)} on {iters.device}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid limit of 65535 pairs")
    return bsz, nx, ny


def stem_fixed_point(ns, vx, vy, ax, ay, l, ux, uy, iters, *,
                     max_iters: int, precision: str = "highest") -> torch.Tensor:
    """u_x^T M u_y after the per-pair closure fixed point.  Returns (B,).

    NS, L: (B, Nx, Ny); Vx, Ax: (B, Nx, Nx); Vy, Ay: (B, Ny, Ny), passed
    untransposed as in the JAX kernel; ux (B, Nx), uy (B, Ny); ``iters`` is
    (B,) int32.  ``precision`` is accepted and runs full f32 (see the
    module docstring).  Operands are checked on both devices.
    """
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    if ns.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_fixed_point runs on cpu or cuda, not {ns.device}")
    bsz, nx, ny = _check(ns, vx, vy, ax, ay, l, ux, uy, iters)
    if ns.device.type == "cpu":
        return stem_fixed_point_reference(ns, vx, vy, ax, ay, l, ux, uy, iters,
                                          max_iters=max_iters)
    out = torch.empty(bsz, device=ns.device, dtype=torch.float32)
    if bsz == 0:
        return out
    m = torch.empty_like(ns)
    g1 = torch.empty_like(ns)
    g2 = torch.empty_like(ns)
    it = torch.clamp(iters, max=max_iters).contiguous()
    with torch.cuda.device(ns.device):
        stream = torch.cuda.current_stream(ns.device).cuda_stream
        rc = load_library().stem_fixed_point_f32(
            ns.data_ptr(), vx.data_ptr(), vy.data_ptr(), ax.data_ptr(),
            ay.data_ptr(), l.data_ptr(), ux.data_ptr(), uy.data_ptr(),
            it.data_ptr(), bsz, nx, ny, max_iters,
            m.data_ptr(), g1.data_ptr(), g2.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point kernel launch failed: CUDA error {rc}")
    stem_fixed_point.launches += 1
    return out


stem_fixed_point.launches = 0  # wrapper calls that launched the kernel
