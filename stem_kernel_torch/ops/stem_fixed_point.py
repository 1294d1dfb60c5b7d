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
units (:data:`MODES`), on both routes and at every node count:

- "highest" -> "f32": f32 FFMA products;
- "high" (the CLI default) -> "3xtf32": each operand x = hi + lo, both TF32
  rounded to nearest (ties away from zero), and hi*hi + hi*lo + lo*hi on
  the tensor cores (up to about 1e-5 relative against f32 on the card);
- "default" -> "bf16": operands rounded to bf16 (nearest even), one pass on
  the tensor cores with f32 accumulation, as the JAX kernel's ``dot_bf``.

On the CPU every name runs f32, as the JAX package's dots do on the CPU.

Routes on the card, chosen by shape (:func:`cluster_route`; node counts
padded to 16 here): pairs with max(Nx, Ny) <= 64 take the cluster kernel,
one launch for the whole fixed point, one CTA a pair
(``stem_fixed_point.launches``); the rest take the per-product route's
strip kernel, also one launch: a pair's columns in strips of 64, one strip
a CTA of a cluster of up to 8 (``stem_fixed_point.launches_wide``).  The
cut-over is where the card's times put it, the same in every mode
(``chip_smoke.py`` phase 5 times every block shape of the stem Gram on the
strip kernel, and on the cluster kernel where it runs): the strip kernel
is slower at 64 x 64, and faster at 64 x 128 and 128 x 128 in every mode
than clusters of four CTAs a pair, so the cluster kernel takes one CTA's
worth, 64 nodes.  A CPU tensor takes :func:`stem_fixed_point_reference`; a
CUDA tensor launches a kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

PRECISIONS = ("highest", "high", "default")
MODES = {"highest": "f32", "high": "3xtf32", "default": "bf16"}
_MODE_IDS = {"f32": 0, "3xtf32": 1, "bf16": 2}
MAX_CLUSTER_NODES = 64  # the largest max(Nx, Ny) that takes the cluster kernel
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
    return bsz, nx, ny


def _round_up(n: int) -> int:
    return -(-n // NODE_MULTIPLE) * NODE_MULTIPLE


def cluster_route(nx: int, ny: int) -> bool:
    """Whether a CUDA batch of (Nx, Ny) pairs takes the cluster kernel, in
    every mode (module docstring: where the card's times put the cut-over);
    the per-product route takes the rest."""
    return max(_round_up(nx), _round_up(ny)) <= MAX_CLUSTER_NODES


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
    """The cluster kernel's launch geometry on the current card (one CTA a
    pair): dynamic shared memory a CTA, and pairs that can be active at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the SMs)."""
    res = (ctypes.c_int * 2)()
    rc = load_library().stem_fixed_point_cluster_info(
        _round_up(nx), _round_up(ny), _MODE_IDS[MODES[precision]], res)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point_cluster_info failed: CUDA error {rc}")
    return {"smem_bytes": res[0], "active_pairs": res[1]}


@functools.cache
def strips_info(nx: int, ny: int, precision: str = "high") -> dict[str, int]:
    """The per-product route's launch geometry on the current card for
    (Nx, Ny) (padded to 16): CTAs a pair, dynamic shared memory a CTA,
    pairs (clusters) active at once, and whether the strip spills to device
    memory, which it does where it does not fit shared memory."""
    res = (ctypes.c_int * 4)()
    rc = load_library().stem_fixed_point_strips_info(
        _round_up(nx), _round_up(ny), _MODE_IDS[MODES[precision]], res)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point_strips_info failed: CUDA error {rc}")
    return {"ctas": res[0], "smem_bytes": res[1], "active_pairs": res[2], "spill": res[3]}


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
    if cluster_route(nx, ny):
        out = cluster_kernel(ns, vx, vy, ax, ay, l, ux, uy, it, precision=precision)
        stem_fixed_point.launches += 1
    else:
        out = per_product_route(ns, vx, vy, ax, ay, l, ux, uy, it, precision=precision)
        stem_fixed_point.launches_wide += 1
    return out


def cluster_kernel(ns, vx, vy, ax, ay, l, ux, uy, iters, *, precision: str) -> torch.Tensor:
    """The cluster kernel on checked CUDA operands with max(Nx, Ny) <= 64
    and ``iters`` already capped: one launch, products in
    ``MODES[precision]``.  The wrapper takes it where :func:`cluster_route`
    says so.  Counts no launch."""
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


def per_product_route(ns, vx, vy, ax, ay, l, ux, uy, iters, *, precision: str) -> torch.Tensor:
    """The per-product route's strip kernel on checked CUDA operands,
    ``iters`` already capped: one launch, any shape, products in
    ``MODES[precision]``; the strip spills to device memory where it does
    not fit shared memory (:func:`strips_info`).  The wrapper takes it where
    :func:`cluster_route` says no; ``chip_smoke.py`` also times it beside
    the cluster kernel.  Counts no launch."""
    bsz, nx, ny = ns.shape
    ops = _pad_nodes([ns, vx, vy, ax, ay, l, ux, uy], nx, ny)
    px, py = ops[0].shape[1], ops[0].shape[2]
    geo = strips_info(px, py, precision)
    out = torch.empty(bsz, device=ns.device, dtype=torch.float32)
    m = torch.empty((bsz, px, py), device=ns.device, dtype=torch.float32)
    g2 = torch.empty_like(m)
    st = torch.empty((bsz, py, px), device=ns.device, dtype=torch.float32) if geo["spill"] else None
    with torch.cuda.device(ns.device):
        rc = load_library().stem_fixed_point_strips(
            *[t.data_ptr() for t in ops], iters.data_ptr(), bsz, px, py,
            _MODE_IDS[MODES[precision]], m.data_ptr(), g2.data_ptr(),
            None if st is None else st.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(ns.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point per-product kernel launch failed: CUDA error {rc}")
    return out


stem_fixed_point.launches = 0  # calls that launched the cluster kernel
stem_fixed_point.launches_wide = 0  # calls that ran the per-product route
