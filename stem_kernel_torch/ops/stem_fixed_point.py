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
  the tensor cores (up to about 2e-5 relative against f32 on the card);
- "default" -> "bf16": operands rounded to bf16 (nearest even), one pass on
  the tensor cores with f32 accumulation, as the JAX kernel's ``dot_bf``.

On the CPU every name runs f32, as the JAX package's dots do on the CPU.

Routes on the card, chosen by shape (:func:`cluster_route`; node counts
padded to 16 here): pairs with max(Nx, Ny) <= 64 take the cluster kernel,
one launch for the whole fixed point, one CTA a pair (counters
``k1.calls.cluster`` and ``k1.pairs.cluster``, utils.tracing); the rest take
the per-product route's tile kernel, also one launch (``k1.calls.tiles``,
``k1.pairs.tiles``): a
pair's columns in strips of 64 (128 in bf16 on a 64-row tile), one strip a
CTA of a cluster of up to 8, the constant operands put in the mode's form
once a call, a producer warp feeding TMA stages to two wgmma warpgroups,
on the geometry :func:`tile_geometry` chooses.  What bounds it and what its design does
about that: the header of the CUDA source.  The cut-over is where the
card's times put it (``chip_smoke.py`` phase 5 times every block shape of
the stem Gram on the per-product route, and on the cluster kernel where
it runs).  A CPU tensor takes :func:`stem_fixed_point_reference`; a CUDA
tensor launches a kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.tracing import count, span
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


# The tile kernel's geometry (csrc/stem_fixed_point.cu, tile_layout: the
# same byte counts)
TILE_ROW_BYTES = 128  # bytes of k a staged row holds: one 128-byte swizzle atom
MAX_TILE_STAGES = 8
MAX_TILE_CTAS = 8  # CTAs a pair: the portable cluster size
MIN_RESIDENT_STAGES = 3  # the strip spills where shared memory leaves fewer stages
SMEM_LIMIT = 232448  # dynamic shared memory a CTA can opt into (H100)


def _mode_sizes(mode: str) -> tuple[int, int]:
    """(planes, bytes an element) of the mode's form."""
    return (2 if mode == "3xtf32" else 1), (2 if mode == "bf16" else 4)


def tile_smem(nx: int, mode: str, rows: int, stages: int, spill: bool, strip: int = 64) -> int:
    """Dynamic shared memory bytes of a tile-kernel CTA (``tile_layout``)."""
    planes, es = _mode_sizes(mode)
    ke = TILE_ROW_BYTES // es
    stage = planes * (rows + strip) * TILE_ROW_BYTES
    resident = 0 if spill else planes * -(-nx // ke) * strip * TILE_ROW_BYTES
    return stages * stage + resident + 8 * (2 * MAX_TILE_STAGES + 1) + 4 * 16 + 1024


def tile_geometry(nx: int, ny: int, precision: str = "high") -> dict:
    """The tile kernel's geometry for (Nx, Ny) (multiples of 16), chosen
    here and nowhere else: the rows tile (64 at Nx <= 64, so that no warp
    idles there; 128 past it, which the card timed faster at 256 and 512),
    the strip's columns (128 in bf16 on the 64-row tile, else 64), CTAs a
    pair (one a strip, up to ``MAX_TILE_CTAS``), the TMA stages (as many as
    shared memory holds, up to 8), whether the strip spills to device
    memory (where it would leave fewer than ``MIN_RESIDENT_STAGES``) and
    whether a stage is released a chunk late (``lag``, where the ring holds
    more than 4 stages).  Each rule is what the card's times chose
    (PERF.md)."""
    mode = MODES[precision]
    rows = 64 if nx <= 64 else 128
    # 128 columns: fewer A bytes a product; faster on the card only here
    strip = 128 if mode == "bf16" and rows == 64 else 64
    nstrips = -(-ny // strip)
    ctas = min(nstrips, MAX_TILE_CTAS)
    planes, _ = _mode_sizes(mode)
    stage = planes * (rows + strip) * TILE_ROW_BYTES

    def room(sp: bool) -> int:
        return (SMEM_LIMIT - tile_smem(nx, mode, rows, 0, sp, strip)) // stage

    spill = room(False) < MIN_RESIDENT_STAGES
    stages = min(MAX_TILE_STAGES, room(spill))
    return {"rows": rows, "strip": strip, "ctas": ctas, "nstrips": nstrips, "stages": stages,
            "spill": bool(spill), "lag": stages > 4,
            "smem_bytes": tile_smem(nx, mode, rows, stages, spill, strip)}


@functools.cache
def strips_info(nx: int, ny: int, precision: str = "high") -> dict:
    """The per-product route's launch geometry on the current card for
    (Nx, Ny) (padded to 16): :func:`tile_geometry`'s choice, and the pairs
    (clusters) that can be active at once."""
    px, py = _round_up(nx), _round_up(ny)
    geo = tile_geometry(px, py, precision)
    res = (ctypes.c_int * 2)()
    rc = load_library().stem_fixed_point_tiles_info(
        px, py, _MODE_IDS[MODES[precision]], geo["rows"], geo["strip"], geo["ctas"],
        geo["stages"], int(geo["spill"]), res)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point_tiles_info failed: CUDA error {rc}")
    if res[0] != geo["smem_bytes"]:
        raise RuntimeError(f"tile_smem says {geo['smem_bytes']} B, the kernel {res[0]} B")
    return {**geo, "active_pairs": res[1]}


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
    with span("k1"):
        bsz, nx, ny = _check(ns, vx, vy, ax, ay, l, ux, uy, iters)
        if ns.device.type == "cpu":
            return stem_fixed_point_reference(ns, vx, vy, ax, ay, l, ux, uy, iters,
                                              max_iters=max_iters)
        if bsz == 0:
            return torch.empty(0, device=ns.device, dtype=torch.float32)
        it = torch.clamp(iters, max=max_iters).contiguous()
        if cluster_route(nx, ny):
            out = cluster_kernel(ns, vx, vy, ax, ay, l, ux, uy, it, precision=precision)
            route = "cluster"
        else:
            out = per_product_route(ns, vx, vy, ax, ay, l, ux, uy, it, precision=precision)
            route = "tiles"
        count(f"k1.calls.{route}")
        count(f"k1.pairs.{route}", bsz)
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where its address is not 16-byte aligned (TMA's rule)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def per_product_route(ns, vx, vy, ax, ay, l, ux, uy, iters, *, precision: str) -> torch.Tensor:
    """The per-product route's tile kernel on checked CUDA operands,
    ``iters`` already capped: one launch, any shape, products in
    ``MODES[precision]``, on :func:`tile_geometry`'s choice; scratch for the
    operands in the mode's form, M, G2 and a spilled strip comes from here.  The wrapper takes it where
    :func:`cluster_route` says no; ``chip_smoke.py`` also times it beside
    the cluster kernel.  Counts no launch."""
    bsz, nx, ny = ns.shape
    ops = [_aligned(t) for t in _pad_nodes([ns, vx, vy, ax, ay, l, ux, uy], nx, ny)]
    px, py = ops[0].shape[1], ops[0].shape[2]
    mode = MODES[precision]
    geo = tile_geometry(px, py, precision)
    planes, _ = _mode_sizes(mode)
    form = torch.bfloat16 if mode == "bf16" else torch.float32
    dev = ns.device

    def scratch(*shape):
        return torch.empty((bsz, planes, *shape), device=dev, dtype=form)

    conv = [None] * 4 if mode == "f32" else [scratch(px, px), scratch(px, px),
                                             scratch(py, py), scratch(py, py)]
    mc, g2c = scratch(px, py), scratch(px, py)
    mf = mc if mode == "f32" else torch.empty((bsz, px, py), device=dev, dtype=torch.float32)
    st = scratch(py, px) if geo["spill"] else None
    out = torch.empty(bsz, device=dev, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = load_library().stem_fixed_point_tiles(
            *[t.data_ptr() for t in ops], iters.data_ptr(), bsz, px, py, _MODE_IDS[mode],
            geo["rows"], geo["strip"], geo["ctas"], geo["stages"], int(geo["spill"]),
            int(geo["lag"]),
            *[ptr(t) for t in conv], mc.data_ptr(), g2c.data_ptr(), mf.data_ptr(), ptr(st),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stem_fixed_point per-product kernel launch failed: CUDA error {rc}")
    return out

