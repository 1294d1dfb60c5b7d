"""The BPLA kernel's log value on ungapped sequences, plain: the structural
profiles from the BPP matrix, the factored score and the log-space local
alignment DP.

Frozen from ``stem_kernel_torch`` (``models/bpla.py``: ``bpla_profiles``,
``bpla_factors``, ``DEFAULT_BPLA_SCORE_TABLE``; ``models/featurize.py:
bpla_features``; ``ops/la.py``: ``la_log_factored_reference`` with
``_log_dp``, ``_factored_emitter``, ``u_closure_matrix``, ``_row_closure``,
``_scalars``), cut to one ungapped row an example (FASTA input):

- the profile is the row's bases, one-hot (no gap column, no IUPAC code
  but the four bases reaches it);
- the BPP matrix is the row's own (``bpmatrix.average_bpp`` of one ungapped
  row is the identity);
- only the log value of the non-SW kernel with the default score table
  (rank 2 + 4, the factored route the program takes);
- ``tf32=True`` rounds the factors fx, fy to TF32 before the emission's
  products (the control); the program's products are f32.

``log_normalized`` is the log-space cosine normalization the CLI writes
(``gram/engine.py:PairKernelEngine.gram``), in float32 as there.
"""

from __future__ import annotations

import numpy as np
import torch

from .products import round_tf32
from .stem import IUPAC_WEIGHT, N_RNA, encode

NEG = -1e30  # log of an empty cell
TINY = float(torch.finfo(torch.float32).tiny)  # smallest normal f32
PAD_MULTIPLE = 8  # models/featurize.py:pad_to

DEFAULT_BPLA_SCORE_TABLE = np.array(
    [
        [5.846613, -1.860000, -1.460000, -1.390000],
        [-1.860000, 4.786613, -2.480000, -1.050000],
        [-1.460000, -2.480000, 4.656613, -1.740000],
        [-1.390000, -1.050000, -1.740000, 5.276613],
    ],
    dtype=np.float32,
)


def pad_to(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def bpla_profiles(bpp: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p_left, p_right, p_unpair) (float32) of an upper-triangular BPP
    matrix: the square roots of the summed pair probabilities on each side
    and of what is left unpaired."""
    left = np.triu(bpp, 1).sum(axis=1)
    right = np.triu(bpp, 1).sum(axis=0)
    unpair = np.clip(1.0 - left - right, 0.0, None)
    return (np.sqrt(left).astype(np.float32), np.sqrt(right).astype(np.float32),
            np.sqrt(unpair).astype(np.float32))


def bpla_features(seq: str, bpp: np.ndarray) -> dict:
    """One sequence's BPLA features, unpadded: the normalized base profile
    (L, 4), p_left, p_right, p_unpair (L,)."""
    base = IUPAC_WEIGHT[encode(seq)]
    tot = base.sum(axis=1, keepdims=True)
    prof = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0).astype(np.float32)
    pl, pr, pu = bpla_profiles(bpp)
    return {"profile": prof, "p_left": pl, "p_right": pr, "p_unpair": pu, "length": len(seq)}


def stack_features(feats: list, width: int, device) -> dict:
    """The features of a batch, each padded to ``width`` positions."""
    b = len(feats)
    prof = np.zeros((b, width, N_RNA), np.float32)
    side = {k: np.zeros((b, width), np.float32) for k in ("p_left", "p_right", "p_unpair")}
    lens = np.zeros(b, np.int32)
    for r, f in enumerate(feats):
        n = f["length"]
        prof[r, :n] = f["profile"]
        for k in side:
            side[k][r, :n] = f[k]
        lens[r] = n
    out = {"profile": prof, "length": lens, **side}
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def bpla_factors(d: dict, score_table: torch.Tensor, side: str) -> torch.Tensor:
    """(B, L, 2 + N) score factors [p_right, p_left, u * prof (@ table on the
    x side)], u = p_unpair / sum(prof), 0 at an empty column."""
    prof, pl, pr, pu = d["profile"], d["p_left"], d["p_right"], d["p_unpair"]
    tot = prof.sum(-1)
    pos = tot > 0
    u = torch.where(pos, pu / torch.where(pos, tot, torch.ones((), device=tot.device)),
                    torch.zeros((), device=tot.device))
    unp = prof * u[..., None]
    if side == "x":
        unp = torch.bmm(unp, score_table.expand(unp.shape[0], *score_table.shape))
    return torch.cat([pr[..., None], pl[..., None], unp], dim=-1)


def _f32(x: float) -> float:
    return torch.tensor(float(x), dtype=torch.float32).item()


def scalars(beta: float, gap: float, ext: float) -> dict:
    """beta, log bg, log be as float32 values (Python floats)."""
    b = torch.tensor(float(beta), dtype=torch.float32)
    lbg = b * torch.tensor(float(gap), dtype=torch.float32)
    lbe = b * torch.tensor(float(ext), dtype=torch.float32)
    return {"beta": b.item(), "lbg": lbg.item(), "lbe": lbe.item()}


def u_closure_matrix(log_bg: float, log_be: float, n: int, *, device) -> torch.Tensor:
    """Tu[k, j] = 1 at j = k+1, bg * be^(j-k-2) at j >= k+2, else 0."""
    k = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    d = (j - k).to(torch.float32)
    geo = torch.exp(log_bg + log_be * torch.clamp(d - 2.0, min=0.0))
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)
    return torch.where(d == 1, one, torch.where(d >= 2, geo, zero))


def _row_closure(v: torch.Tensor, tu: torch.Tensor) -> torch.Tensor:
    """v @ Tu, one (1, n) @ (n, n) product per row."""
    return torch.bmm(v[:, None, :], tu.expand(v.shape[0], *tu.shape))[:, 0]


def la_log_factored(fx, fy, lx, ly, alpha: float, beta: float, gap: float, ext: float,
                    tf32: bool = False) -> torch.Tensor:
    """log K (B,) of the LA kernel on rank-K factors: the row-rescaled
    log-space closure over rows i < max_lx, each row's log emission
    alpha*beta*(pair slots) + beta*(other slots), summed slot by slot."""
    sc = scalars(beta, gap, ext)
    if tf32:
        fx, fy = round_tf32(fx), round_tf32(fy)
    rank, max_lx, max_ly = fx.shape[2], fx.shape[1], fy.shape[1]
    ab = _f32(_f32(alpha) * sc["beta"])
    coef = torch.tensor([ab, ab] + [sc["beta"]] * (rank - 2), dtype=torch.float32,
                        device=fx.device)
    fxs = fx * coef
    dev = lx.device
    rows = torch.arange(max_lx, device=dev)[None, :] < lx[:, None]
    cols = torch.arange(max_ly, device=dev)[None, :] < ly[:, None]
    bsz = lx.shape[0]
    tu = u_closure_matrix(sc["lbg"], sc["lbe"], max_ly, device=dev)
    neg = torch.full((), NEG, device=dev)
    zero = torch.zeros((), device=dev)
    la = torch.full((bsz, max_ly), NEG, device=dev)
    lg = torch.full_like(la, NEG)
    acc = torch.full((bsz,), NEG, device=dev)
    for i in range(max_lx):
        emit = fxs[:, i, 0:1] * fy[:, :, 0]
        for k in range(1, rank):
            emit = emit + fxs[:, i, k:k + 1] * fy[:, :, k]
        le = torch.where(cols & rows[:, i:i + 1], emit, neg)
        s = torch.logaddexp(la, sc["lbg"] + lg)
        m = le + torch.logaddexp(zero, s)
        r = m.amax(1, keepdim=True)
        em = torch.exp(m - r)
        av = _row_closure(em, tu)
        lg = torch.logaddexp(sc["lbe"] + lg, la)
        la = torch.where(av >= TINY, r + torch.log(av), neg)
        acc = torch.logaddexp(acc, r[:, 0] + torch.log(torch.clamp(em.sum(1), min=TINY)))
    return torch.logaddexp(zero, acc)


def log_normalized(lk: np.ndarray, lk_x: np.ndarray, lk_y: np.ndarray) -> np.ndarray:
    """exp(L_xy - (L_xx + L_yy)/2) of log values (float32, as the engine
    normalizes its float32 log Gram)."""
    g, dx, dy = (np.asarray(v, np.float32) for v in (lk, lk_x, lk_y))
    return np.exp(g - 0.5 * (dx + dy)).astype(np.float32)
