"""Structure-DAG construction from base-pair probability matrices.

Host-side equivalent of the reference's DAG construction
(stem_kernel/stem_kernel_lite/data.cpp): candidate base pairs with
P >= threshold become nodes (stems), unpaired spans become loops/leaves, and
edges carry gap counts; plus the Profiler quantities (per-position unpaired
probability, weighted base-pair frequency profiles) and the postprocessing
passes find_root / find_max_parent / fill_weight
(data.cpp:396-453).

Port of ``stem_kernel_tpu/models/dag.py``.  The output is an array encoding
for the batched stem kernel:

- dense per-node features (bp_freq as a flat 16-vector, weights, spans),
- dense (N, N) edge-coefficient matrices A (match path) and B (gap path),
- the **gap-closure** V = (I - B)^{-1} and **root-reach** vector
  u = (I - T^T)^{-1} r (T = unweighted child matrix, r = root indicator).
  Both inverses exist because the DAGs are acyclic (B, T strictly
  triangular in topological order), and they are what turns the reference's
  per-cell IX/IY recursions (stem_kernel.cpp:61-86) into closed-form
  matmuls — see models/stem_kernel.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.alphabet import IUPAC_WEIGHT, N_RNA, RNA_GAP, encode
from ..io.profile import Alignment, index_map


@dataclass
class StemDAG:
    """Array-encoded structure DAG for one example (alignment)."""

    n_nodes: int
    first: np.ndarray  # (N,) span start (alignment columns)
    last: np.ndarray  # (N,) span end
    weight: np.ndarray  # (N,) node weight (loop profile product)
    bp_freq: np.ndarray  # (N, 16) flattened 4x4 base-pair frequency profile
    nbp_frac: np.ndarray  # (N,) gap fraction at `first` (profile[first][GAP]/n_rows)
    is_leaf: np.ndarray  # (N,) bool
    edge_to: np.ndarray  # (E,) child node index
    edge_gaps: np.ndarray  # (E,) gap count of the edge
    edge_weight: np.ndarray  # (E,) edge weight (1.0 in the reference)
    edge_ptr: np.ndarray  # (N+1,) CSR row pointers
    root: np.ndarray  # (R,) root node indices
    max_pa: np.ndarray  # (N,) liveness bound (diagnostic parity)
    depth: int  # max node depth in edges (match-iteration bound)
    pos_weight: np.ndarray  # (L,) per-position loop-profile weights (string kernel)


class _Profiler:
    """Per-row profile quantities (Profiler, data.cpp:32-137), vectorized."""

    def __init__(self, row: str, bpp: np.ndarray, w: float = 1.0):
        self.row = row
        self.bpp = bpp  # row's own (ungapped) matrix OR the shared column matrix
        self.w = w
        self.idx = index_map(row)
        codes = encode(row)
        self.pr = IUPAC_WEIGHT[codes]  # (L, 4); zero rows at gaps
        L = len(row)
        own = bpp.shape[0] != L  # per-row ungapped matrix
        tot_by_pos = bpp.sum(axis=0) + bpp.sum(axis=1)  # pairing prob per position
        self.nbp = np.ones(L, dtype=np.float64)
        present = self.idx >= 0
        if own:
            self.nbp[present] = np.maximum(1.0 - tot_by_pos[self.idx[present]], 0.0)
        else:
            self.nbp[present] = np.maximum(1.0 - tot_by_pos[np.flatnonzero(present)], 0.0)

    def loop_profile_vec(self) -> np.ndarray:
        """w * nbp at present columns, 0 elsewhere (for averaging)."""
        return np.where(self.idx >= 0, self.w * self.nbp, 0.0)

    def bp_profiles_at(self, firsts: np.ndarray, lasts: np.ndarray) -> np.ndarray:
        """(N, 4, 4) weighted base-pair frequency contributions per node."""
        fi, li = self.idx[firsts], self.idx[lasts]
        ok = (fi >= 0) & (li >= 0)
        if self.bpp.shape[0] != len(self.row):
            p = np.where(ok, self.bpp[np.clip(fi, 0, None), np.clip(li, 0, None)], 0.0)
        else:
            p = np.where(ok, self.bpp[firsts, lasts], 0.0)
        return (self.w * p)[:, None, None] * np.einsum(
            "na,nb->nab", self.pr[firsts], self.pr[lasts]
        )


def _dag_topology(avg_bpp: np.ndarray, L: int, th: float):
    """Node spans + CSR edges by the native C++ scan (``native/dagscan.cpp``).

    The candidate-pair scan and DFS emission of DAGBuilder
    (data.cpp:163-258): children precede parents in the output order.
    ``_dag_topology_python`` is its plain version.
    """
    from .. import native

    return native.dag_scan_native(np.asarray(avg_bpp, np.float64), th)


def _dag_topology_python(avg_bpp: np.ndarray, L: int, th: float):
    """The plain version of ``_dag_topology``: the same scan in Python."""
    bp_children: dict[tuple[int, int], list[tuple[int, int]]] = {}
    head: list[list[tuple[int, int]]] = [[] for _ in range(L)]
    ch: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for j in range(1, L):
        for i in range(j - 1, -1, -1):
            if avg_bpp[i, j] >= th:
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

    first_l: list[int] = []
    last_l: list[int] = []
    edges_l: list[list[tuple[int, int]]] = []  # (to, gaps)
    visited: dict[tuple[int, int], int] = {}

    def emit(pos: tuple[int, int]) -> int:
        if pos in visited:
            return visited[pos]
        i, j = pos
        kids: list[tuple[int, int]] = []
        if i != j:
            cur = bp_children.get(pos)
            if not cur:  # loop: one edge to leaf (i, i)
                kids.append((emit((i, i)), j - i - 1))
            else:  # stem: edges to child pairs
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
    if not first_l:  # completely unstructured input: single leaf
        emit((0, 0))

    edge_to, edge_gaps, edge_ptr = [], [], [0]
    for e in edges_l:
        for (to, gaps) in e:
            edge_to.append(to)
            edge_gaps.append(gaps)
        edge_ptr.append(len(edge_to))
    return (
        np.asarray(first_l, np.int32),
        np.asarray(last_l, np.int32),
        np.asarray(edge_to, np.int32),
        np.asarray(edge_gaps, np.int32),
        np.asarray(edge_ptr, np.int32),
    )


def build_dag(
    aln: Alignment,
    avg_bpp: np.ndarray,
    row_bpps: list[np.ndarray] | None,
    th: float = 0.01,
) -> StemDAG:
    """Build the structure DAG of an alignment.

    ``avg_bpp``: (L, L) upper-triangular matrix over alignment columns used
    for thresholding; ``row_bpps``: per-row ungapped matrices for profile
    quantities (None -> every row uses ``avg_bpp``, the alifold case).
    """
    L = aln.length
    rows = aln.rows
    if row_bpps is None:
        profs = [_Profiler(r, avg_bpp) for r in rows]
    else:
        profs = [_Profiler(r, b) for r, b in zip(rows, row_bpps)]
    total_w = sum(p.w for p in profs)

    first, last, edge_to, edge_gaps, edge_ptr = _dag_topology(avg_bpp, L, th)
    n = len(first)
    edge_w = np.ones(len(edge_to), np.float32)
    n_edges_per = edge_ptr[1:] - edge_ptr[:-1]
    is_leaf = n_edges_per == 0

    # vectorized profile quantities over all nodes at once
    lp = np.zeros(L)
    for p in profs:
        lp += p.loop_profile_vec()
    lp = lp / total_w  # averaged loop profile per column
    weight = np.where(is_leaf, 1.0, lp[first] * lp[last]).astype(np.float32)
    bp_acc = np.zeros((n, N_RNA, N_RNA))
    for p in profs:
        bp_acc += p.bp_profiles_at(first, last)
    bp_freq = (bp_acc / total_w).reshape(n, N_RNA * N_RNA).astype(np.float32)
    bp_freq[is_leaf] = 0.0

    # roots / max parent (find_root, find_max_parent — data.cpp:396-435)
    is_root = np.ones(n, bool)
    is_root[edge_to] = False
    root = np.flatnonzero(is_root).astype(np.int32)
    max_pa = np.full(n, -1, np.int64)
    for parent in range(n):
        for e in range(edge_ptr[parent], edge_ptr[parent + 1]):
            max_pa[edge_to[e]] = max(max_pa[edge_to[e]], parent)

    # depth (children precede parents in topological emission order)
    depth_arr = np.zeros(n, np.int32)
    for parent in range(n):
        lo, hi = edge_ptr[parent], edge_ptr[parent + 1]
        if hi > lo:
            depth_arr[parent] = 1 + depth_arr[edge_to[lo:hi]].max()

    # per-row gap fraction at `first` (SubstNodeScore gap correction uses
    # seq[first][RNA_GAP] / n_seqs, score_table.cpp:190-197)
    gap_count = np.zeros(L)
    for p in profs:
        gap_count += (p.idx < 0).astype(np.float64)
    nbp_frac = (gap_count[first] / total_w).astype(np.float32)

    pos_weight = lp.astype(np.float32)

    return StemDAG(
        n_nodes=n,
        first=first,
        last=last,
        weight=weight,
        bp_freq=bp_freq,
        nbp_frac=nbp_frac,
        is_leaf=is_leaf,
        edge_to=edge_to,
        edge_gaps=edge_gaps,
        edge_weight=edge_w,
        edge_ptr=edge_ptr,
        root=root,
        max_pa=max_pa,
        depth=int(depth_arr.max()) if n else 0,
        pos_weight=pos_weight,
    )


def dag_operators(dag: StemDAG, loop_gap: float, n_pad: int) -> dict[str, np.ndarray]:
    """Raw dense operators for the closure-matmul stem kernel, padded.

    A[i, c]   = sum over edges i->c of gap^gaps * e_w           (match path)
    T[i, c]   = edge multiplicity (unweighted)                  (path counts)
    r         = root indicator
    leaf      = leaf indicator (base case K0 = G0 = 1 at leaf-leaf pairs)

    The gap-closure V = (I - B)^{-1} and root-reach u = (I - T^T)^{-1} r are
    NOT computed here — :func:`closure_features` solves them batched on
    device (children precede parents in topological order, so I - B is unit
    lower-triangular and the closures are batched triangular solves, not
    host-side O(N^3) LAPACK per example).
    """
    n = dag.n_nodes
    A = np.zeros((n_pad, n_pad), np.float64)
    T = np.zeros((n_pad, n_pad), np.float64)
    np.add.at(
        A,
        (np.repeat(np.arange(n), np.diff(dag.edge_ptr)), dag.edge_to),
        (loop_gap ** dag.edge_gaps.astype(np.float64)) * dag.edge_weight,
    )
    np.add.at(
        T, (np.repeat(np.arange(n), np.diff(dag.edge_ptr)), dag.edge_to), 1.0
    )
    gap2w = (loop_gap ** 2) * dag.weight.astype(np.float64)
    r = np.zeros(n_pad)
    r[dag.root] = 1.0
    leaf = np.zeros(n_pad, np.float32)
    leaf[:n][dag.is_leaf] = 1.0
    feats = {
        "A": A.astype(np.float32),
        "T": T.astype(np.float32),
        "r": r.astype(np.float32),
        "leaf": leaf,
        "bp_freq": np.zeros((n_pad, N_RNA * N_RNA), np.float32),
        "gap2w": np.zeros(n_pad, np.float32),
        "nbp_frac": np.zeros(n_pad, np.float32),
        "length": np.zeros(n_pad, np.float32),
        "valid": np.zeros(n_pad, np.float32),
    }
    feats["bp_freq"][:n] = dag.bp_freq
    feats["gap2w"][:n] = gap2w.astype(np.float32)
    feats["nbp_frac"][:n] = dag.nbp_frac
    feats["length"][:n] = (dag.last - dag.first).astype(np.float32)
    feats["valid"][:n] = 1.0
    # per-example match-nesting depth: the pair fixed point converges after
    # min(depth_x, depth_y) + 1 iterations (ops/pallas_stem dynamic bound)
    feats["depth"] = np.asarray(dag.depth, np.int32)
    return feats


def closure_features(feats: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Solve the DAG closures for a stacked batch on ``device``.

    Input: stacked :func:`dag_operators` dicts (leading batch axis).
    Output: the same keys as tensors on ``device``, with V = (I - B)^{-1} and
    u = (I - T^T)^{-1} r added and the raw T dropped.  Children precede
    parents, so B and T are strictly lower-triangular: I - B is unit lower
    and I - T^T unit upper, and both closures are batched triangular solves
    in f32.
    """
    out = {k: torch.as_tensor(np.asarray(v), device=device)
           for k, v in feats.items() if k != "T"}
    V, u = _closures_impl(out["A"], out["gap2w"],
                          torch.as_tensor(feats["T"], device=device), out["r"])
    out["V"] = V
    out["u"] = u
    return out


def _closures_impl(A: torch.Tensor, gap2w: torch.Tensor, T: torch.Tensor,
                   r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n_pad = A.shape[-1]
    eye = torch.eye(n_pad, dtype=A.dtype, device=A.device)
    B = A * gap2w[..., :, None]
    # (I - B) V = I, I - B unit lower-triangular
    V = torch.linalg.solve_triangular(eye - B, eye.expand_as(B).contiguous(),
                                      upper=False, unitriangular=True)
    # (I - T^T) u = r, I - T^T unit upper-triangular
    u = torch.linalg.solve_triangular(eye - T.transpose(-1, -2), r[..., None],
                                      upper=True, unitriangular=True)[..., 0]
    return V, u
