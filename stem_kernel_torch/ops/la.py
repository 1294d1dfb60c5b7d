"""Local-alignment (LA) DP: CUDA kernels, plain versions, wrappers, dispatchers.

The 5-state sum-over-local-alignments DP of the BPLA and protein LA kernels,
in the M-only closure form of ``stem_kernel_tpu/ops/pallas_la.py``.  Per
pair, over the rows i < lx of the (lx, ly) emission block:

    m = e * (1 + a + bg*g);   a' = m @ Tu;   g' = be*g + a;   K = 1 + sum m

with e = exp(log emission), Tu[k, j] = 1 at j = k+1 and bg*be^(j-k-2)
beyond (:func:`u_closure_matrix`), bg = exp(beta*gap), be = exp(beta*ext).
The log-space twin keeps la = log a and lg = log g and evaluates the closure
rescaled by the row maximum r of m:

    a' = r + log(exp(m - r) @ Tu)

and returns log K = logaddexp(0, acc).  A closure below the smallest normal
f32 (TINY, 1.18e-38) counts as empty: a' = NEG.  The TPU kernels write
``log(max(av, 1e-38))``, but XLA flushes subnormals, so their floor is 0
and such a cell is log 0 there too.  A true subnormal floor would make up
mass: on 160 x 160 scores of 15 it lifts log K from 326.0 to 335.9.

Four wrappers replace the four Pallas TPU kernels:

- :func:`la_log_factored` (``la_log_factored``, K2) and
  :func:`la_exp_factored` (``la_exp_factored``, K3) build each emission row
  from rank-K factors, K <= 6:
  le[i, j] = alpha*beta*(fx[i,0]fy[j,0] + fx[i,1]fy[j,1])
             + beta * sum_{k>=2} fx[i,k]fy[j,k];
- :func:`la_exp` (``la_exp_pallas``, K4) and :func:`la_log`
  (``la_log_pallas``, K5) read a materialised (B, Lx, Ly) score tensor, or
  the affine ``alpha*scores + scores2`` of two, and le = beta*s.

Padded cells (rows >= lx, columns >= ly) are masked exactly: e = 0, or
le = NEG = -1e30 in log space.  A length past its axis counts as the axis.

Dispatch: a CPU tensor takes the wrapper's plain version
(``<wrapper>_reference``: the closure with an explicit Tu product, one
``bmm`` row at a time); a CUDA tensor launches the kernel in
``stem_kernel_torch/csrc/la_dp.cu`` or raises.  Nothing falls back.  Each
call, on either device, is a span ``la`` and counts its pairs in
``la.<wrapper>.pairs`` and its padded cells (B * max_lx * max_ly) in
``la.<wrapper>.cells_padded``; each kernel launch counts in
``la.<wrapper>.calls``, and those on a lane geometry in
``la.<wrapper>.lanes`` (utils.tracing).
Every kernel runs on a lane geometry, lanes a pair by columns a lane, that
the route picks from the padded shape: :func:`log_route` for the log
kernels (K2, K5, ``LOG_ROUTE``), :func:`exp_route` for the exp ones (K3,
K4, ``EXP_ROUTE``), each placed by ``chip_smoke.py``'s geometry table;
(0, 0) is the one-warp kernel.  :func:`la_log_factored_at`,
:func:`la_log_at`, :func:`la_exp_factored_at` and :func:`la_exp_at` launch
a given geometry.
"""

from __future__ import annotations

import functools

import torch

from ..utils.tracing import count, span
from ._build import load_library

NEG = -1e30  # log of an empty cell; never -inf, so logaddexp never meets inf - inf
TINY = float(torch.finfo(torch.float32).tiny)  # smallest normal f32
MAX_RANK = 6  # factor slots of the factored kernels
MAX_LY = 32768  # the CUDA kernel: 32 warps of 1024 columns (csrc/la_dp.cu); the CPU has no limit
# (largest padded width max_ly, lanes, columns) the log kernels K2 and K5
# take on the card, placed by chip_smoke.py's geometry table (phase 11);
# past the last row the one-warp kernel, which also takes every width past
# 1024 columns
LOG_ROUTE = ((32, 32, 1), (64, 32, 2), (128, 32, 4), (256, 128, 2), (512, 128, 4))
# the lane geometries (lanes a pair, columns a lane) that the library holds
# (csrc/la_dp.cu, la_log_lanes): the route's; (0, 0) is the one-warp kernel
LOG_GEOMETRIES = tuple((lanes, cols) for _, lanes, cols in LOG_ROUTE)
# (largest padded width max_ly, lanes, columns) the exp kernels take on the
# card, K3 (factored) and K4 (scores) apart, placed by chip_smoke.py's
# geometry table (phase 11); past the last row, and past LANE_MAX_LEN rows,
# the one-warp kernel
EXP_ROUTE = {"factored": ((32, 32, 1), (128, 64, 2), (256, 128, 2), (512, 128, 4)),
             "scores": ((32, 32, 1), (64, 64, 1), (128, 128, 1), (256, 128, 2), (512, 128, 4))}
# the lane geometries of each exp kernel that the library holds
# (csrc/la_dp.cu, la_exp_lanes): its route's
EXP_GEOMETRIES = {kind: tuple((lanes, cols) for _, lanes, cols in route)
                  for kind, route in EXP_ROUTE.items()}
# The lane kernels take pairs up to 512 rows and columns, the longest that
# chip_smoke.py's phase 6 holds them to (256 pairs of 384-512).  Past that
# the one-warp kernel, which repeats the plain version's arithmetic, runs:
# there two f32 evaluations of log K drift 1e-3 and more apart on some
# pairs, the plain version and an f64 one too (la_log_numerics.py).
LANE_MAX_LEN = 512


def _scalars(beta, gap, ext) -> dict[str, float]:
    """beta, log bg, log be, bg, be as float32 values (Python floats)."""
    return _scalars_of(float(beta), float(gap), float(ext))


@functools.cache
def _scalars_of(beta: float, gap: float, ext: float) -> dict[str, float]:
    """:func:`_scalars`, cached by value: a Gram asks once a batch for the
    same three numbers, and the torch scalar ops cost more host time than
    a short kernel.  Callers read the dict and never change it."""
    b = torch.tensor(beta, dtype=torch.float32)
    lbg = b * torch.tensor(gap, dtype=torch.float32)
    lbe = b * torch.tensor(ext, dtype=torch.float32)
    return {"beta": b.item(), "lbg": lbg.item(), "lbe": lbe.item(),
            "bg": torch.exp(lbg).item(), "be": torch.exp(lbe).item()}


def _f32(x) -> float:
    return _f32_of(float(x))


@functools.cache
def _f32_of(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


def u_closure_matrix(log_bg: float, log_be: float, n: int, *, device) -> torch.Tensor:
    """Tu[k, j] = u(j-k): 1 at j=k+1, bg*be^(j-k-2) at j>=k+2, else 0."""
    k = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    d = (j - k).to(torch.float32)
    geo = torch.exp(log_bg + log_be * torch.clamp(d - 2.0, min=0.0))
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)
    return torch.where(d == 1, one, torch.where(d >= 2, geo, zero))


def _row_closure(v: torch.Tensor, tu: torch.Tensor) -> torch.Tensor:
    """v @ Tu, one (1, n) @ (n, n) product per row: a folded GEMM would
    block by the row count, and a pair's value would depend on its batch."""
    return torch.bmm(v[:, None, :], tu.expand(v.shape[0], *tu.shape))[:, 0]


def _masks(lx, ly, max_lx: int, max_ly: int):
    rows = torch.arange(max_lx, device=lx.device)[None, :] < lx[:, None]
    cols = torch.arange(max_ly, device=ly.device)[None, :] < ly[:, None]
    return rows, cols


def _exp_dp(emit_row, lx, ly, max_lx: int, max_ly: int, sc: dict) -> torch.Tensor:
    """1 + sum M of the exp-space closure; ``emit_row(i)`` is the (B, Ly)
    log emission of row i."""
    rows, cols = _masks(lx, ly, max_lx, max_ly)
    bsz = lx.shape[0]
    tu = u_closure_matrix(sc["lbg"], sc["lbe"], max_ly, device=lx.device)
    a = torch.zeros(bsz, max_ly, device=lx.device)
    g = torch.zeros_like(a)
    acc = torch.zeros(bsz, device=lx.device)
    for i in range(max_lx):
        mask = cols & rows[:, i:i + 1]
        e = torch.where(mask, torch.exp(emit_row(i)), torch.zeros((), device=lx.device))
        m = e * (1.0 + a + sc["bg"] * g)
        a_new = _row_closure(m, tu)
        g = sc["be"] * g + a
        a = a_new
        acc = acc + m.sum(1)
    return 1.0 + acc


def _log_dp(emit_row, lx, ly, max_lx: int, max_ly: int, sc: dict) -> torch.Tensor:
    """log(1 + sum M) by the row-rescaled log-space closure."""
    rows, cols = _masks(lx, ly, max_lx, max_ly)
    bsz = lx.shape[0]
    tu = u_closure_matrix(sc["lbg"], sc["lbe"], max_ly, device=lx.device)
    neg = torch.full((), NEG, device=lx.device)
    zero = torch.zeros((), device=lx.device)
    la = torch.full((bsz, max_ly), NEG, device=lx.device)
    lg = torch.full_like(la, NEG)
    acc = torch.full((bsz,), NEG, device=lx.device)
    for i in range(max_lx):
        mask = cols & rows[:, i:i + 1]
        le = torch.where(mask, emit_row(i), neg)
        s = torch.logaddexp(la, sc["lbg"] + lg)
        m = le + torch.logaddexp(zero, s)
        r = m.amax(1, keepdim=True)
        em = torch.exp(m - r)
        av = _row_closure(em, tu)
        lg = torch.logaddexp(sc["lbe"] + lg, la)
        la = torch.where(av >= TINY, r + torch.log(av), neg)
        acc = torch.logaddexp(acc, r[:, 0] + torch.log(torch.clamp(em.sum(1), min=TINY)))
    return torch.logaddexp(zero, acc)


def _factored_emitter(fx, fy, alpha, sc):
    """Row i of alpha*beta*(pair slots) + beta*(other slots), summed slot by
    slot in order (elementwise, so batch-invariant)."""
    rank = fx.shape[2]
    ab = _f32(_f32(alpha) * sc["beta"])
    coef = torch.tensor([ab, ab] + [sc["beta"]] * (rank - 2), dtype=torch.float32,
                        device=fx.device)
    fxs = fx * coef

    def emit_row(i):
        le = fxs[:, i, 0:1] * fy[:, :, 0]
        for k in range(1, rank):
            le = le + fxs[:, i, k:k + 1] * fy[:, :, k]
        return le

    return emit_row


def _scores_emitter(scores, scores2, alpha, sc):
    beta = sc["beta"]
    if scores2 is None:
        return lambda i: beta * scores[:, i]
    a = _f32(alpha)
    return lambda i: beta * (a * scores[:, i] + scores2[:, i])


def la_exp_factored_reference(fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """Plain torch version of :func:`la_exp_factored`."""
    sc = _scalars(beta, gap, ext)
    return _exp_dp(_factored_emitter(fx, fy, alpha, sc), lx, ly, fx.shape[1], fy.shape[1], sc)


def la_log_factored_reference(fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """Plain torch version of :func:`la_log_factored`."""
    sc = _scalars(beta, gap, ext)
    return _log_dp(_factored_emitter(fx, fy, alpha, sc), lx, ly, fx.shape[1], fy.shape[1], sc)


def la_exp_reference(scores, lx, ly, beta, gap, ext, *, scores2=None,
                     alpha=1.0) -> torch.Tensor:
    """Plain torch version of :func:`la_exp`."""
    sc = _scalars(beta, gap, ext)
    _, max_lx, max_ly = scores.shape
    return _exp_dp(_scores_emitter(scores, scores2, alpha, sc), lx, ly, max_lx, max_ly, sc)


def la_log_reference(scores, lx, ly, beta, gap, ext, *, scores2=None,
                     alpha=1.0) -> torch.Tensor:
    """Plain torch version of :func:`la_log`."""
    sc = _scalars(beta, gap, ext)
    _, max_lx, max_ly = scores.shape
    return _log_dp(_scores_emitter(scores, scores2, alpha, sc), lx, ly, max_lx, max_ly, sc)


# ------------------------------------------------------------------ checks

def _check_tensor(name: str, t, shape: tuple, dtype, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name}: need {dtype} on {dev}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous tensor")


def _check_common(lead: torch.Tensor, lx, ly, max_ly: int) -> None:
    dev = lead.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the LA kernels run on cpu or cuda, not {dev}")
    bsz = lead.shape[0]
    _check_tensor("lx", lx, (bsz,), torch.int32, dev)
    _check_tensor("ly", ly, (bsz,), torch.int32, dev)
    if dev.type == "cuda" and max_ly > MAX_LY:
        raise ValueError(f"Ly = {max_ly} exceeds the CUDA kernel's limit of {MAX_LY} columns")


def _check_factored(fx, fy, lx, ly) -> None:
    if not isinstance(fx, torch.Tensor) or fx.dim() != 3:
        raise ValueError("fx must be a (B, Lx, K) tensor")
    bsz, max_lx, rank = fx.shape
    if not 2 <= rank <= MAX_RANK:
        raise ValueError(
            f"factored LA kernels support rank 2..{MAX_RANK} (got K={rank}); use "
            "la_exp_affine_auto / la_log_affine_auto for higher-rank score tables")
    if not isinstance(fy, torch.Tensor) or fy.dim() != 3:
        raise ValueError("fy must be a (B, Ly, K) tensor")
    _check_tensor("fx", fx, (bsz, max_lx, rank), torch.float32, fx.device)
    _check_tensor("fy", fy, (bsz, fy.shape[1], rank), torch.float32, fx.device)
    _check_common(fx, lx, ly, fy.shape[1])


def _check_scores(scores, scores2, lx, ly) -> None:
    if not isinstance(scores, torch.Tensor) or scores.dim() != 3:
        raise ValueError("scores must be a (B, Lx, Ly) tensor")
    shape = tuple(scores.shape)
    _check_tensor("scores", scores, shape, torch.float32, scores.device)
    if scores2 is not None:
        _check_tensor("scores2", scores2, shape, torch.float32, scores.device)
    _check_common(scores, lx, ly, shape[2])


# ------------------------------------------------------------------ launch

def _route(table, max_lx: int, max_ly: int) -> tuple[int, int]:
    if max_lx <= LANE_MAX_LEN:
        for limit, lanes, cols in table:
            if max_ly <= limit:
                return lanes, cols
    return 0, 0


def log_route(max_lx: int, max_ly: int) -> tuple[int, int]:
    """(lanes, columns a lane) of the log kernels for a batch padded to
    ``max_lx`` rows and ``max_ly`` columns; (0, 0) is the one-warp kernel.  A
    pair's bits depend on the geometry, so on the padded shape, never on
    the batch."""
    return _route(LOG_ROUTE, max_lx, max_ly)


def exp_route(max_lx: int, max_ly: int, factored: bool) -> tuple[int, int]:
    """(lanes, columns a lane) of the exp kernel K3 (``factored``) or K4, as
    :func:`log_route`."""
    return _route(EXP_ROUTE["factored" if factored else "scores"], max_lx, max_ly)


def _launch(wrapper, entry: str, ptrs: list, lx, ly, dims: list, floats: list,
            dev) -> torch.Tensor:
    """Run one entry point of the library on the current stream; (B,) f32.
    ``dims`` ends with the geometry (lanes, cols)."""
    out = torch.empty(lx.shape[0], device=dev, dtype=torch.float32)
    if lx.shape[0] == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load_library(), entry)(
            *ptrs, lx.data_ptr(), ly.data_ptr(), *dims,
            *floats, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    count(f"la.{wrapper.__name__}.calls")
    count(f"la.{wrapper.__name__}.lanes", int(dims[-2] != 0))
    return out


def _geometry_dims(geometry, max_lx: int, max_ly: int, log: bool = True,
                   factored: bool = True) -> list:
    """[lanes, cols] of a launch: ``geometry``, or the route's."""
    if log:
        library = LOG_GEOMETRIES
        route = log_route(max_lx, max_ly)
    else:
        library = EXP_GEOMETRIES["factored" if factored else "scores"]
        route = exp_route(max_lx, max_ly, factored)
    lanes, cols = route if geometry is None else geometry
    if (lanes, cols) != (0, 0) and ((lanes, cols) not in library or lanes * cols < max_ly):
        raise ValueError(f"no {'log' if log else 'exp'} kernel of {lanes} lanes x {cols} "
                         f"columns for Ly = {max_ly}")
    return [lanes, cols]


def _call_span(wrapper, bsz: int, max_lx: int, max_ly: int):
    """The span ``la`` of one call of ``wrapper``, its pairs and padded
    cells counted from the shapes."""
    count(f"la.{wrapper.__name__}.pairs", bsz)
    count(f"la.{wrapper.__name__}.cells_padded", bsz * max_lx * max_ly)
    return span("la")


def _factored(wrapper, entry, reference, fx, fy, lx, ly, alpha, beta, gap, ext, *,
              log: bool, geometry=None):
    _check_factored(fx, fy, lx, ly)
    bsz, max_lx, rank = fx.shape
    with _call_span(wrapper, bsz, max_lx, fy.shape[1]):
        if fx.device.type == "cpu":
            return reference(fx, fy, lx, ly, alpha, beta, gap, ext)
        sc = _scalars(beta, gap, ext)
        geo = _geometry_dims(geometry, max_lx, fy.shape[1], log, factored=True)
        return _launch(wrapper, entry, [fx.data_ptr(), fy.data_ptr()], lx, ly,
                       [bsz, max_lx, fy.shape[1], rank, *geo],
                       [_f32(alpha), sc["beta"], sc["bg"], sc["be"], sc["lbg"], sc["lbe"]],
                       fx.device)


def _materialised(wrapper, entry, reference, scores, lx, ly, beta, gap, ext,
                  scores2, alpha, *, log: bool, geometry=None):
    _check_scores(scores, scores2, lx, ly)
    bsz, max_lx, max_ly = scores.shape
    with _call_span(wrapper, bsz, max_lx, max_ly):
        if scores.device.type == "cpu":
            return reference(scores, lx, ly, beta, gap, ext, scores2=scores2, alpha=alpha)
        sc = _scalars(beta, gap, ext)
        s2 = None if scores2 is None else scores2.data_ptr()
        geo = _geometry_dims(geometry, max_lx, max_ly, log, factored=False)
        return _launch(wrapper, entry, [scores.data_ptr(), s2], lx, ly,
                       [bsz, max_lx, max_ly, *geo],
                       [_f32(alpha), sc["beta"], sc["bg"], sc["be"], sc["lbg"], sc["lbe"]],
                       scores.device)


def la_log_factored(fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """log K of the LA kernel on rank-K factors (K2).  fx (B, Lx, K),
    fy (B, Ly, K) float32 with 2 <= K <= 6; lx, ly (B,) int32.  Returns (B,)."""
    return _factored(la_log_factored, "la_log_factored_f32", la_log_factored_reference,
                     fx, fy, lx, ly, alpha, beta, gap, ext, log=True)


def la_exp_factored(fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """K of the LA kernel on rank-K factors (K3); shapes as
    :func:`la_log_factored`.  Overflows f32 for long, well-matched pairs."""
    return _factored(la_exp_factored, "la_exp_factored_f32", la_exp_factored_reference,
                     fx, fy, lx, ly, alpha, beta, gap, ext, log=False)


def la_exp(scores, lx, ly, beta, gap, ext, *, scores2=None, alpha=1.0) -> torch.Tensor:
    """K of the LA kernel on a (B, Lx, Ly) float32 score tensor (K4), or on
    ``alpha*scores + scores2`` when ``scores2`` is given.  Returns (B,)."""
    return _materialised(la_exp, "la_exp_f32", la_exp_reference, scores, lx, ly,
                         beta, gap, ext, scores2, alpha, log=False)


def la_log(scores, lx, ly, beta, gap, ext, *, scores2=None, alpha=1.0) -> torch.Tensor:
    """log K of the LA kernel on a materialised score tensor (K5); as
    :func:`la_exp`, overflow-safe at any length."""
    return _materialised(la_log, "la_log_f32", la_log_reference, scores, lx, ly,
                         beta, gap, ext, scores2, alpha, log=True)


def la_log_factored_at(geometry, fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """:func:`la_log_factored` on the card at ``geometry`` = (lanes, cols),
    or (0, 0) for the one-warp kernel, whatever the route: how the geometry table is
    measured.  Counts in ``la.la_log_factored.calls``."""
    if fx.device.type != "cuda":
        raise ValueError("a lane geometry is a CUDA launch; the CPU has one plain version")
    return _factored(la_log_factored, "la_log_factored_f32", la_log_factored_reference,
                     fx, fy, lx, ly, alpha, beta, gap, ext, log=True, geometry=geometry)


def la_log_at(geometry, scores, lx, ly, beta, gap, ext, *, scores2=None,
              alpha=1.0) -> torch.Tensor:
    """:func:`la_log` on the card at ``geometry``, as :func:`la_log_factored_at`."""
    if scores.device.type != "cuda":
        raise ValueError("a lane geometry is a CUDA launch; the CPU has one plain version")
    return _materialised(la_log, "la_log_f32", la_log_reference, scores, lx, ly, beta, gap,
                         ext, scores2, alpha, log=True, geometry=geometry)


def la_exp_factored_at(geometry, fx, fy, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """:func:`la_exp_factored` on the card at ``geometry``, as
    :func:`la_log_factored_at`.  Counts in ``la.la_exp_factored.calls``."""
    if fx.device.type != "cuda":
        raise ValueError("a lane geometry is a CUDA launch; the CPU has one plain version")
    return _factored(la_exp_factored, "la_exp_factored_f32", la_exp_factored_reference,
                     fx, fy, lx, ly, alpha, beta, gap, ext, log=False, geometry=geometry)


def la_exp_at(geometry, scores, lx, ly, beta, gap, ext, *, scores2=None,
              alpha=1.0) -> torch.Tensor:
    """:func:`la_exp` on the card at ``geometry``, as :func:`la_log_factored_at`."""
    if scores.device.type != "cuda":
        raise ValueError("a lane geometry is a CUDA launch; the CPU has one plain version")
    return _materialised(la_exp, "la_exp_f32", la_exp_reference, scores, lx, ly, beta, gap,
                         ext, scores2, alpha, log=False, geometry=geometry)


# ------------------------------------------------------------- dispatchers
# The JAX package picks Pallas or a scan by jax.default_backend(); here the
# wrappers pick by the tensor's device, so the dispatchers only name the
# materialised and affine forms.

def la_exp_auto(scores, lx, ly, beta, gap, ext) -> torch.Tensor:
    return la_exp(scores, lx, ly, beta, gap, ext)


def la_log_auto(scores, lx, ly, beta, gap, ext) -> torch.Tensor:
    return la_log(scores, lx, ly, beta, gap, ext)


def la_exp_affine_auto(w_pair, w_unpair, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """exp-space LA on scores = alpha*w_pair + w_unpair, fused in the kernel."""
    return la_exp(w_pair, lx, ly, beta, gap, ext, scores2=w_unpair, alpha=alpha)


def la_log_affine_auto(w_pair, w_unpair, lx, ly, alpha, beta, gap, ext) -> torch.Tensor:
    """log-space LA on scores = alpha*w_pair + w_unpair, fused in the kernel."""
    return la_log(w_pair, lx, ly, beta, gap, ext, scores2=w_unpair, alpha=alpha)
