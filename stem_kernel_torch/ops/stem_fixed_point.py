"""Stem-kernel closure fixed point: CUDA kernel, plain version, wrapper.

Per pair b, starting from M = 0, repeat ``iters[b]`` times (capped at
``max_iters``)

    G = Vx (M Vy^T + L);      M = NS * (Ax G Ay^T)

and return ux^T M uy, shape (B,).  This replaces the Pallas TPU kernel
``stem_kernel_tpu/ops/pallas_stem.py:stem_fixed_point``; the CUDA source is
``stem_kernel_torch/csrc/stem_fixed_point.cu``, whose header says what bounds
it on the card and what its design does about it.

Precision.  In the JAX package the names count MXU passes: "highest" is
full f32, "high" three bf16 passes (about 9e-4 relative against f32),
"default" one bf16 pass (about 6e-2).  On the card they map onto Hopper's
units (:data:`MODES`):

- "highest" -> "f32": f32 FFMA products;
- "high" (the CLI default) -> "3xtf32": each operand x = hi + lo, both TF32
  rounded to nearest (ties away from zero), and hi*hi + hi*lo + lo*hi on
  the tensor cores (up to about 1e-5 relative against f32 on the card);
- "default" -> "bf16": operands rounded to bf16 (nearest even), one pass on
  the tensor cores with f32 accumulation, as the JAX kernel's ``dot_bf``.

On the CPU every name runs f32, as the JAX package's dots do on the CPU.

Routes on the card, chosen by shape and mode (:func:`cluster_route`): pairs
with max(Nx, Ny) <= 128 (node counts padded to 16 here) take the cluster
kernel, one launch for the whole fixed point, 1 or 4 CTAs a pair
(``stem_fixed_point.launches``); the rest take the per-product kernel, four
launches an iteration, f32 for every name (``stem_fixed_point.launches_wide``).
The cut-over is where the card's times put it (``chip_smoke.py`` phase 5
times every block shape of the stem Gram on both routes): past 128 nodes a
pair needs 16-CTA clusters, slower than the per-product kernel at every such
shape in every mode; and in 3xTF32 a cluster whose four CTAs hold 16 rows
each (Nx <= 64 < Ny) is slower too.  A CPU tensor takes
:func:`stem_fixed_point_reference`; a CUDA tensor launches a kernel or
raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library

PRECISIONS = ("highest", "high", "default")
MODES = {"highest": "f32", "high": "3xtf32", "default": "bf16"}
_MODE_IDS = {"f32": 0, "3xtf32": 1, "bf16": 2}
MAX_CLUSTER_NODES = 128  # the largest max(Nx, Ny) that takes the cluster kernel
NODE_MULTIPLE = 16  # the cluster kernel's tile: node counts are padded to it


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits) rounded to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``; the result is f32 with the low 13 bits zero.
    Subnormals round the same way; inf and nan pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 == ~0x1fff
    return torch.where(torch.isfinite(x), rounded, x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 rounded to nearest even, back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo with hi = tf32(x), lo = tf32(x - hi): the 3xTF32 split."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def _bmm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with the operands rounded as the kernel's mode rounds them."""
    if mode == "f32":
        return torch.bmm(a, b)
    if mode == "bf16":
        return torch.bmm(round_bf16(a), round_bf16(b))
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)


def stem_fixed_point_reference(ns, vx, vy, ax, ay, l, ux, uy, iters, *,
                               max_iters: int, mode: str = "f32") -> torch.Tensor:
    """Plain torch version: a ``bmm`` loop with a per-pair mask.  ``mode``
    ("f32", "3xtf32" or "bf16") rounds the operands of each product as the
    kernel does; the bilinear form is f32."""
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown mode {mode!r}")
    it = torch.clamp(iters, max=max_iters)
    vyt = vy.transpose(1, 2)
    ayt = ay.transpose(1, 2)
    m = torch.zeros_like(ns)
    for k in range(max_iters):
        g = _bmm(vx, _bmm(m, vyt, mode) + l, mode)
        m_new = ns * _bmm(ax, _bmm(g, ayt, mode), mode)
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


def _round_up(n: int) -> int:
    return -(-n // NODE_MULTIPLE) * NODE_MULTIPLE


def cluster_route(nx: int, ny: int, precision: str) -> bool:
    """Whether a CUDA batch of (Nx, Ny) pairs takes the cluster kernel at
    ``precision`` (module docstring: where the card's times put the cut-over)."""
    px, py = _round_up(nx), _round_up(ny)
    if max(px, py) > MAX_CLUSTER_NODES:
        return False
    return not (MODES[precision] == "3xtf32" and px <= 64 < py)


def _pad_nodes(ops: list, nx: int, ny: int) -> list:
    """Zero-pad the node axes to (px, py), multiples of 16.  Padded rows and
    columns of every operand are 0, so M and the value do not change."""
    px, py = _round_up(nx), _round_up(ny)
    if (px, py) == (nx, ny):
        return ops
    pads = [(py - ny, px - nx), (px - nx, px - nx), (py - ny, py - ny),
            (px - nx, px - nx), (py - ny, py - ny), (py - ny, px - nx),
            (px - nx,), (py - ny,)]
    out = []
    for t, pd in zip(ops, pads):
        spec = (0, pd[0], 0, pd[1]) if len(pd) == 2 else (0, pd[0])
        out.append(F.pad(t, spec).contiguous())
    return out


def cluster_info(nx: int, ny: int, precision: str = "high") -> dict[str, int]:
    """The cluster kernel's launch geometry on the current card: CTAs a
    pair, dynamic shared memory a CTA, and clusters that can be active at
    once (``cudaOccupancyMaxActiveClusters``)."""
    res = (ctypes.c_int * 3)()
    rc = load_library().stem_fixed_point_cluster_info(
        _round_up(nx), _round_up(ny), _MODE_IDS[MODES[precision]], res)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point_cluster_info failed: CUDA error {rc}")
    return {"ctas": res[0], "smem_bytes": res[1], "active_clusters": res[2]}


def stem_fixed_point(ns, vx, vy, ax, ay, l, ux, uy, iters, *,
                     max_iters: int, precision: str = "highest") -> torch.Tensor:
    """u_x^T M u_y after the per-pair closure fixed point.  Returns (B,).

    NS, L: (B, Nx, Ny); Vx, Ax: (B, Nx, Nx); Vy, Ay: (B, Ny, Ny), passed
    untransposed as in the JAX kernel; ux (B, Nx), uy (B, Ny); ``iters`` is
    (B,) int32.  ``precision`` picks the card's product mode (module
    docstring); the CPU runs f32.  Operands are checked on both devices.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if ns.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_fixed_point runs on cpu or cuda, not {ns.device}")
    bsz, nx, ny = _check(ns, vx, vy, ax, ay, l, ux, uy, iters)
    if ns.device.type == "cpu":
        return stem_fixed_point_reference(ns, vx, vy, ax, ay, l, ux, uy, iters,
                                          max_iters=max_iters)
    if bsz == 0:
        return torch.empty(0, device=ns.device, dtype=torch.float32)
    it = torch.clamp(iters, max=max_iters).contiguous()
    if cluster_route(nx, ny, precision):
        out = cluster_kernel(ns, vx, vy, ax, ay, l, ux, uy, it, precision=precision)
        stem_fixed_point.launches += 1
    else:
        out = per_product_route(ns, vx, vy, ax, ay, l, ux, uy, it, max_iters=max_iters)
        stem_fixed_point.launches_wide += 1
    return out


def cluster_kernel(ns, vx, vy, ax, ay, l, ux, uy, iters, *, precision: str) -> torch.Tensor:
    """The cluster kernel on checked CUDA operands with max(Nx, Ny) <= 128
    and ``iters`` already capped: one launch.  The wrapper takes it where
    :func:`cluster_route` says so; ``chip_smoke.py`` also times it at the
    other shapes it can run, beside the per-product kernel.  Counts no launch."""
    bsz, nx, ny = ns.shape
    ops = _pad_nodes([ns, vx, vy, ax, ay, l, ux, uy], nx, ny)
    out = torch.empty(bsz, device=ns.device, dtype=torch.float32)
    with torch.cuda.device(ns.device):
        rc = load_library().stem_fixed_point_cluster(
            *[t.data_ptr() for t in ops], iters.data_ptr(), bsz, ops[0].shape[1],
            ops[0].shape[2], _MODE_IDS[MODES[precision]], out.data_ptr(),
            torch.cuda.current_stream(ns.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point cluster kernel launch failed: CUDA error {rc}")
    return out


def per_product_route(ns, vx, vy, ax, ay, l, ux, uy, iters, *, max_iters: int) -> torch.Tensor:
    """The per-product kernel on checked CUDA operands, f32, any shape:
    four launches an iteration and one for the bilinear form.  The wrapper
    takes it where :func:`cluster_route` says no; ``chip_smoke.py`` also
    times it beside the cluster kernel.  Counts no launch."""
    out = torch.empty(ns.shape[0], device=ns.device, dtype=torch.float32)
    m, g1, g2 = torch.empty_like(ns), torch.empty_like(ns), torch.empty_like(ns)
    with torch.cuda.device(ns.device):
        rc = load_library().stem_fixed_point_f32(
            ns.data_ptr(), vx.data_ptr(), vy.data_ptr(), ax.data_ptr(), ay.data_ptr(),
            l.data_ptr(), ux.data_ptr(), uy.data_ptr(), iters.data_ptr(), ns.shape[0],
            ns.shape[1], ns.shape[2], max_iters, m.data_ptr(), g1.data_ptr(), g2.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(ns.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point per-product kernel launch failed: CUDA error {rc}")
    return out


stem_fixed_point.launches = 0  # calls that launched the cluster kernel
stem_fixed_point.launches_wide = 0  # calls that ran the per-product route
