"""Scaled McCaskill fold DP on the card: the CUDA kernel's wrapper.

The kernel (``stem_kernel_torch/csrc/fold_dp.cu``) replaces no Pallas
kernel: the JAX package folds with the ``lax.scan`` code of
``stem_kernel_tpu/fold/mccaskill_scaled.py``.  It runs the inside pass, the
exterior chains and the outside pass of every sequence of a fold batch in
one launch, one thread block a sequence; its header says what bounds it and
what its design does about that.  On the card it gives the plain
version's bits: it rounds and sums as the plain version's torch ops do
there (the header lists the orders).  The plain version, which CPU tensors
take, is :func:`..fold.mccaskill_scaled.mccaskill_bpp_batch_scaled_reference`;
:func:`..fold.mccaskill_scaled.mccaskill_bpp_batch_scaled` routes by device.

:func:`fold_dp` takes the batch's LUTs in span layout, as
``mccaskill_scaled._kernel_tables`` gives them, and CUDA tensors only: it
launches the kernel or raises.  The interior-loop offsets of the parameter
set (:func:`offset_table`, the nonzero entries of
``mccaskill_scaled._class_kernels``) are built on the host once a parameter
set and kept on the device.  Each launch counts ``fold.batches.kernel``
(utils.tracing) and :func:`launches`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.tracing import count
from ._build import load_library

LOG_TABLES = ("hairpin", "ext_stem")  # read as log scores; every other LUT as exp(min(., 60))
MAX_EXPLICIT, MAX_CLASSES = 8, 4  # csrc/fold_dp.cu: MAX_EXPL, MAX_CLS

_launches = 0


def launches() -> int:
    """Kernel launches of this process."""
    return _launches


def _scaled():
    # fold.mccaskill_scaled imports this module to route to the kernel
    from ..fold import mccaskill_scaled

    return mccaskill_scaled


def table_names(params) -> tuple[str, ...]:
    """The LUTs the kernel reads, in its order: the log tables, wpair, stack,
    ml_close, ml_stem, the explicit small-loop terms, the loop classes'
    outer and inner mismatch factors."""
    ms = _scaled()
    cls_out, cls_in = ms._cls_names(params)
    return (*LOG_TABLES, "wpair", "stack", "ml_close", "ml_stem",
            *(name for name, _, _ in ms._expl_terms(params)), *cls_out, *cls_in)


@dataclass(frozen=True)
class OffsetTable:
    """The interior-loop offsets (a, b) of one parameter set whose weight is
    not 0, by loop class, then a, then t = a + b (the order of the plain
    engine's matmul over t for each a): ``w`` = exp(penalty) in f32 (the
    value of ``_class_kernels(params)[cls][t, a]``), ``t``, ``a``, ``cls``;
    ``seg[c * cdim + a]`` the first offset of (c, a), ``seg[-1]`` their
    count."""

    w: np.ndarray
    t: np.ndarray
    a: np.ndarray
    cls: np.ndarray
    seg: np.ndarray
    cdim: int


def _offset_key(params) -> tuple:
    """Every field ``mccaskill_scaled._interior_offsets`` reads."""
    def arr(x):
        return None if x is None else np.asarray(x, np.float64).tobytes()

    return (int(params.max_interior), bool(getattr(params, "fast", False)),
            arr(params.bulge_len), arr(params.interior_len), float(params.lxc),
            float(params.ninio), float(params.ninio_max), arr(params.interior_asym_table),
            arr(params.interior_explicit))


_CACHE_SIZE = 16  # parameter sets (and widths) whose tables stay cached
_tables: dict = {}
_constants: dict = {}


def _cached(cache: dict, key, build):
    if key not in cache:
        if len(cache) >= _CACHE_SIZE:
            cache.clear()
        cache[key] = build()
    return cache[key]


def _build_offset_table(params) -> OffsetTable:
    ms = _scaled()
    ia, ib, ipen, icls = ms._interior_offsets(params)
    cdim = params.max_interior + 3
    ncls = len(ms._cls_names(params)[0])
    t = (ia + ib).astype(np.int32)
    w = np.exp(np.asarray(ipen, np.float64)).astype(np.float32)
    keep = np.flatnonzero(w != 0)  # an offset whose weight is 0 in f32 adds nothing
    order = keep[np.lexsort((t[keep], ia[keep], icls[keep]))]
    w, cls, t, a = w[order], icls[order].astype(np.int32), t[order], ia[order].astype(np.int32)
    seg = np.searchsorted(cls.astype(np.int64) * cdim + a, np.arange(ncls * cdim + 1))
    return OffsetTable(w, t, a, cls, seg.astype(np.int32), cdim)


def offset_table(params) -> OffsetTable:
    """The interior-loop offset table of ``params`` (built once a parameter set)."""
    return _cached(_tables, _offset_key(params), lambda: _build_offset_table(params))


def _device_constants(params, n: int, device: torch.device):
    """(offset table, its weights, its int32 metadata, c^t (n,)) on ``device``."""
    def build():
        tab = offset_table(params)
        meta = np.concatenate([tab.t, tab.a, tab.cls, tab.seg])
        # c^t as the plain version computes it: f64, cast once
        cpow = np.exp(params.ml_unpaired * np.arange(n, dtype=np.float64)).astype(np.float32)
        return (tab, torch.as_tensor(tab.w, device=device),
                torch.as_tensor(meta.astype(np.int32), device=device),
                torch.as_tensor(cpow, device=device))

    key = (_offset_key(params), float(params.ml_unpaired), n, device)
    return _cached(_constants, key, build)


def _check(name: str, t, shape: tuple, dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor")


def _check_device(tensors: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"the fold DP kernel runs on cuda, not {dev}; CPU tensors take "
                         "the plain engine of fold.mccaskill_scaled")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, not {dev}")
    return dev


def fold_dp(tables: dict, lengths: torch.Tensor, params) -> tuple[torch.Tensor, torch.Tensor]:
    """(bpp (B, n, n) in [i, j] layout, logZ (B,)), both float32.

    ``tables``: each of :func:`table_names` as a contiguous (B, n, n)
    float32 CUDA tensor in span layout ([b, d, i] = lut[b, i, i + d]), the
    log tables as log scores, the others as exp(min(score, 60)); ``lengths``:
    (B,) int32 on the same card (a length past n counts as n).
    """
    global _launches
    names = table_names(params)
    missing = [k for k in names if k not in tables]
    if missing:
        raise ValueError(f"tables: missing {missing}")
    first = tables[names[0]]
    if not isinstance(first, torch.Tensor) or first.dim() != 3:
        raise ValueError(f"{names[0]}: need a (B, n, n) tensor")
    bsz, n = first.shape[0], first.shape[1]
    for k in names:
        _check(k, tables[k], (bsz, n, n), torch.float32)
    _check("lengths", lengths, (bsz,), torch.int32)
    dev = _check_device({**{k: tables[k] for k in names}, "lengths": lengths})
    expl = _scaled()._expl_terms(params)
    ncls = (len(names) - len(LOG_TABLES) - 4 - len(expl)) // 2
    if len(expl) > MAX_EXPLICIT or ncls > MAX_CLASSES:
        raise ValueError(f"the fold DP kernel takes at most {MAX_EXPLICIT} explicit terms and "
                         f"{MAX_CLASSES} loop classes, not {len(expl)} and {ncls}")
    bpp = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
    logz = torch.empty(bsz, dtype=torch.float32, device=dev)
    if bsz == 0:
        return bpp, logz
    tab, w, meta, cpow = _device_constants(params, n, dev)
    lib = load_library()
    n_off = len(tab.w)
    scratch = torch.empty(lib.fold_dp_scratch_floats(bsz, n, ncls, tab.cdim, n_off),
                          dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(names))(*(tables[k].data_ptr() for k in names))
    ds = (ctypes.c_int * MAX_EXPLICIT)(*(d for _, d, _ in expl))
    sh = (ctypes.c_int * MAX_EXPLICIT)(*(s for _, _, s in expl))
    c_lin = float(np.float32(np.exp(params.ml_unpaired)))
    c_ext = float(np.float32(params.ext_unpaired))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fold_dp_f32(ptrs, ds, sh, len(expl), ncls, tab.cdim, n_off, w.data_ptr(),
                             meta.data_ptr(), cpow.data_ptr(), c_lin, c_ext, lengths.data_ptr(),
                             bsz, n, scratch.data_ptr(), bpp.data_ptr(), logz.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fold_dp_f32 kernel launch failed: CUDA error {rc}")
    _launches += 1
    count("fold.batches.kernel")
    return bpp, logz


def route(n: int, params) -> tuple[bool, int]:
    """(whether the kernel keeps its work vectors in shared memory, their
    bytes) at padded width ``n``."""
    tab = offset_table(params)
    nbytes = ctypes.c_longlong(0)
    ncls = len(_scaled()._cls_names(params)[0])
    smem = load_library().fold_dp_route(n, ncls, tab.cdim, len(tab.w), ctypes.byref(nbytes))
    return bool(smem), nbytes.value
