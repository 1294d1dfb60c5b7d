"""The stem_kernel_lite kernel on ungapped sequences, plain: fold, DAG,
closures, the closure fixed point, the profile string kernel.

Frozen from ``stem_kernel_torch`` (``fold/bpmatrix.py:fold_sequences``,
``models/dag.py`` with its Python scan, ``models/stem_kernel.py``,
``ops/stem_fixed_point.py:stem_fixed_point_reference``,
``models/string_kernel.py``, ``ops/recurrence.py``), cut to one ungapped
row an example (FASTA input): the averaged BPP matrix is the row's own, the
profiles are the row's bases, and no gap column exists.
"""

from __future__ import annotations

import numpy as np
import torch

from .mccaskill_scaled import mccaskill_bpp_batch_scaled
from .params import default_params
from .products import matmul, round_tf32
from .ribosum_data import RIBOSUM_P, RIBOSUM_S

N_RNA = 4
MAX_BATCH_CELLS = 1 << 24  # fold/bpmatrix.py: padded table cells a fold batch
_CHAR_TO_CODE = np.full(256, 15, dtype=np.uint8)  # unknown -> N
for _i, _c in enumerate("acgu-rymkswbdhvn"):
    _CHAR_TO_CODE[ord(_c)] = _i
    _CHAR_TO_CODE[ord(_c.upper())] = _i
_CHAR_TO_CODE[ord("t")] = _CHAR_TO_CODE[ord("T")] = 3
IUPAC_WEIGHT = np.zeros((16, N_RNA), np.float32)
for _code, _bases in enumerate(((0,), (1,), (2,), (3,), (), (0, 2), (1, 3), (0, 1), (2, 3),
                                (1, 2), (0, 3), (1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2),
                                (0, 1, 2, 3))):
    for _b in _bases:
        IUPAC_WEIGHT[_code, _b] = 1.0 / len(_bases)


def encode(seq: str) -> np.ndarray:
    return _CHAR_TO_CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


# ------------------------------------------------------------------ fold

def fold_sequences(seqs: list, *, device) -> list:
    """BPP matrix (float64, host) per sequence, folded in the batches the
    program folds them in: sorted by length, cut at ``MAX_BATCH_CELLS``
    padded cells, each batch padded to its longest."""
    params = default_params()
    codes_all = [encode(s) for s in seqs]
    order = sorted(range(len(seqs)), key=lambda i: len(codes_all[i]))
    groups, cur = [], []
    for i in order:
        n = max(len(codes_all[i]), 1)
        if cur and (len(cur) + 1) * n * n > MAX_BATCH_CELLS:
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)
    out = [None] * len(seqs)
    for idxs in groups:
        lpad = max(1, max(len(codes_all[i]) for i in idxs))
        codes = np.zeros((len(idxs), lpad), np.uint8)
        lens = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            codes[r, :len(codes_all[i])] = codes_all[i]
            lens[r] = len(codes_all[i])
        bpps, _ = mccaskill_bpp_batch_scaled(codes, lens, params, device=device)
        host = bpps.cpu().numpy()
        for r, i in enumerate(idxs):
            out[i] = np.asarray(host[r, :lens[r], :lens[r]], dtype=np.float64)
    return out


# ------------------------------------------------------------------- DAG

def _dag_topology(bpp: np.ndarray, L: int, th: float):
    """Candidate-pair scan and DFS emission (children precede parents):
    ``models/dag.py:_dag_topology_python``."""
    bp_children: dict = {}
    head: list = [[] for _ in range(L)]
    ch: dict = {}
    for j in range(1, L):
        for i in range(j - 1, -1, -1):
            if bpp[i, j] >= th:
                bp_children[(i, j)] = ch.pop((i + 1, j - 1), [])
                ch.setdefault((i, j), []).append((i, j))
                head[i].append((i, j))
            else:
                lst = []
                upper = ch.get((i + 1, j), [])
                if head[i]:
                    widest_end = head[i][-1][1]
                    lst.extend(x for x in upper if x[1] >= widest_end)
                else:
                    lst.extend(upper)
                lst.extend(head[i])
                ch[(i, j)] = lst
    first_l, last_l, edges_l, visited = [], [], [], {}

    def emit(pos) -> int:
        if pos in visited:
            return visited[pos]
        i, j = pos
        kids = []
        if i != j:
            cur = bp_children.get(pos)
            if not cur:
                kids.append((emit((i, i)), j - i - 1))
            else:
                for c in cur:
                    kids.append((emit(c), (c[0] - i - 1) + (j - c[1] - 1)))
        first_l.append(i)
        last_l.append(j)
        edges_l.append(kids)
        visited[pos] = len(first_l) - 1
        return visited[pos]

    for i in range(L):
        for pos in reversed(head[i]):
            emit(pos)
    if not first_l:
        emit((0, 0))
    edge_to, edge_gaps, edge_ptr = [], [], [0]
    for e in edges_l:
        for to, gaps in e:
            edge_to.append(to)
            edge_gaps.append(gaps)
        edge_ptr.append(len(edge_to))
    return (np.asarray(first_l, np.int32), np.asarray(last_l, np.int32),
            np.asarray(edge_to, np.int32), np.asarray(edge_gaps, np.int32),
            np.asarray(edge_ptr, np.int32))


def stem_features(seq: str, bpp: np.ndarray, th: float, loop_gap: float) -> dict:
    """One sequence's DAG operators (``models/dag.py``: ``build_dag`` then
    ``dag_operators``, unpadded) and its string-kernel profile."""
    L = len(seq)
    codes = encode(seq)
    pr = IUPAC_WEIGHT[codes]
    tot = bpp.sum(axis=0) + bpp.sum(axis=1)
    nbp = np.maximum(1.0 - tot, 0.0)  # the loop profile of the one row
    first, last, edge_to, edge_gaps, edge_ptr = _dag_topology(bpp, L, th)
    n = len(first)
    is_leaf = (edge_ptr[1:] - edge_ptr[:-1]) == 0
    weight = np.where(is_leaf, 1.0, nbp[first] * nbp[last]).astype(np.float32)
    p = bpp[first, last]
    bp_freq = (p[:, None, None] * np.einsum("na,nb->nab", pr[first], pr[last]))
    bp_freq = bp_freq.reshape(n, N_RNA * N_RNA).astype(np.float32)
    bp_freq[is_leaf] = 0.0
    is_root = np.ones(n, bool)
    is_root[edge_to] = False
    depth = np.zeros(n, np.int32)
    for parent in range(n):
        lo, hi = edge_ptr[parent], edge_ptr[parent + 1]
        if hi > lo:
            depth[parent] = 1 + depth[edge_to[lo:hi]].max()
    rows = np.repeat(np.arange(n), np.diff(edge_ptr))
    A = np.zeros((n, n), np.float64)
    T = np.zeros((n, n), np.float64)
    np.add.at(A, (rows, edge_to), loop_gap ** edge_gaps.astype(np.float64))
    np.add.at(T, (rows, edge_to), 1.0)
    prof = pr / np.where(pr.sum(1, keepdims=True) > 0, pr.sum(1, keepdims=True), 1.0)
    return {"n": n, "depth": int(depth.max()) if n else 0,
            "A": A.astype(np.float32), "T": T.astype(np.float32),
            "r": is_root.astype(np.float32), "leaf": is_leaf.astype(np.float32),
            "bp_freq": bp_freq, "gap2w": ((loop_gap ** 2) * weight.astype(np.float64)
                                          ).astype(np.float32),
            "nbp_frac": np.zeros(n, np.float32),
            "length": (last - first).astype(np.float32), "valid": np.ones(n, np.float32),
            "str_profile": prof.astype(np.float32), "str_weight": nbp.astype(np.float32),
            "str_length": L}


def stack_features(feats: list, n_pad: int, l_pad: int, device) -> dict:
    """Examples padded to ``n_pad`` nodes and ``l_pad`` positions, stacked
    on ``device``, with the closures V = (I - B)^-1 and u = (I - T^T)^-1 r
    (``models/dag.py:closure_features``)."""
    b = len(feats)
    out = {k: np.zeros((b, n_pad, n_pad), np.float32) for k in ("A", "T")}
    for k in ("r", "leaf", "gap2w", "nbp_frac", "length", "valid"):
        out[k] = np.zeros((b, n_pad), np.float32)
    out["bp_freq"] = np.zeros((b, n_pad, N_RNA * N_RNA), np.float32)
    out["str_profile"] = np.zeros((b, l_pad, N_RNA), np.float32)
    out["str_weight"] = np.zeros((b, l_pad), np.float32)
    for i, f in enumerate(feats):
        n, L = f["n"], f["str_length"]
        for k in ("A", "T"):
            out[k][i, :n, :n] = f[k]
        for k in ("r", "leaf", "gap2w", "nbp_frac", "length", "valid", "bp_freq"):
            out[k][i, :n] = f[k]
        out["str_profile"][i, :L] = f["str_profile"]
        out["str_weight"][i, :L] = f["str_weight"]
    t = {k: torch.as_tensor(v, device=device) for k, v in out.items()}
    t["depth"] = torch.as_tensor([f["depth"] for f in feats], dtype=torch.int32, device=device)
    t["str_length"] = torch.as_tensor([f["str_length"] for f in feats], device=device)
    eye = torch.eye(n_pad, device=device)
    B = t["A"] * t["gap2w"][..., :, None]
    t["V"] = torch.linalg.solve_triangular(eye - B, eye.expand_as(B).contiguous(),
                                           upper=False, unitriangular=True)
    t["u"] = torch.linalg.solve_triangular(eye - t["T"].transpose(-1, -2), t["r"][..., None],
                                           upper=True, unitriangular=True)[..., 0]
    return t


# ---------------------------------------------------------- stem kernel

def stem_values(x: dict, y: dict, beta: float, len_band: int, tf32: bool) -> torch.Tensor:
    """Stem-kernel values (B,) of gathered pairs: node scores, then the
    closure fixed point from M = 0, min(depth_x, depth_y) + 1 trips a pair,

        G = Vx (M Vy^T + L);      M = NS * (Ax G Ay^T)

    and ux^T M uy plus the leaf-leaf base term."""
    dev = x["A"].device
    co = torch.as_tensor(np.exp(RIBOSUM_P * beta).reshape(16, 16).astype(np.float32),
                         device=dev)
    ns = matmul(matmul(x["bp_freq"], co, tf32), y["bp_freq"].transpose(1, 2), tf32)
    ns = ns + x["nbp_frac"][:, :, None] * y["gap2w"][:, None, :]
    ns = ns + x["gap2w"][:, :, None] * y["nbp_frac"][:, None, :]
    ok = ((1.0 - x["leaf"])[:, :, None] * (1.0 - y["leaf"])[:, None, :]
          * x["valid"][:, :, None] * y["valid"][:, None, :])
    if len_band > 0:
        ok = ok * (torch.abs(x["length"][:, :, None] - y["length"][:, None, :])
                   <= len_band).to(ns.dtype)
    ns = ns * ok
    leaf = x["leaf"][:, :, None] * y["leaf"][:, None, :]
    trips = torch.minimum(x["depth"], y["depth"]) + 1
    vyt, ayt = y["V"].transpose(1, 2), y["A"].transpose(1, 2)
    m = torch.zeros_like(ns)
    for k in range(int(trips.max())):
        g = matmul(x["V"], matmul(m, vyt, tf32) + leaf, tf32)
        m_new = ns * matmul(x["A"], matmul(g, ayt, tf32), tf32)
        m = torch.where((trips > k)[:, None, None], m_new, m)
    value = torch.einsum("bi,bij,bj->b", x["u"], m, y["u"])
    return value + (x["u"] * x["leaf"]).sum(-1) * (y["r"] * y["leaf"]).sum(-1)


# -------------------------------------------------------- string kernel

def toeplitz_powers(a: float, n: int, device) -> torch.Tensor:
    """(n, n) T[s, t] = a^(t-s) for t >= s, 0 below (built in f64)."""
    idx = torch.arange(n, device=device, dtype=torch.float64)
    lag = idx[None, :] - idx[:, None]
    t = torch.where(lag >= 0, torch.as_tensor(float(a), dtype=torch.float64, device=device)
                    ** lag.clamp(min=0), torch.zeros((), dtype=torch.float64, device=device))
    return t.to(torch.float32)


def string_values(x: dict, y: dict, alpha: float, gap: float, tf32: bool) -> torch.Tensor:
    """Profile string kernel K0[|x|][|y|] (B,) of gathered pairs, the
    loop-profile weights on both sides."""
    dev = x["str_profile"].device
    subst = torch.as_tensor(np.exp(RIBOSUM_S * alpha).astype(np.float32), device=dev)
    px, py = x["str_profile"], y["str_profile"]
    num = matmul(matmul(px, subst, tf32), py.transpose(1, 2), tf32)
    den = px.sum(-1)[:, :, None] * py.sum(-1)[:, None, :]  # sum_ab px[i,a] py[j,b]
    zero = den == 0
    scores = torch.where(zero, torch.ones_like(num),
                         num / torch.where(zero, torch.ones_like(den), den))
    scores = scores * (x["str_weight"][:, :, None] * y["str_weight"][:, None, :])
    mx = torch.arange(px.shape[1], device=dev)[None, :] < x["str_length"][:, None]
    my = torch.arange(py.shape[1], device=dev)[None, :] < y["str_length"][:, None]
    scores = scores * (mx[:, :, None] & my[:, None, :])
    bsz, lx, ly = scores.shape
    tmat = toeplitz_powers(gap, ly, dev)
    tmat = (round_tf32(tmat) if tf32 else tmat).expand(bsz, ly, ly)
    k0 = torch.ones((bsz, ly + 1), device=dev)
    g0 = (torch.tensor(float(gap), device=dev)
          ** torch.arange(ly + 1, dtype=torch.float32, device=dev)).expand(bsz, ly + 1)
    ones = torch.ones((bsz, 1), device=dev)
    for i in range(lx):
        v = g0[:, :-1] * scores[:, i, :]
        k1 = torch.cumsum(v, dim=-1)
        g1 = torch.bmm(round_tf32(v[:, None, :]) if tf32 else v[:, None, :], tmat)[:, 0, :]
        k0 = torch.cat([ones, k1 + k0[:, 1:]], dim=-1)
        g0 = torch.cat([g0[:, :1] * gap, g1 + gap * g0[:, 1:]], dim=-1)
    return k0[:, -1]
