# Frozen copy of stem_kernel_torch/fold/params.py for skbench's plain reference:
# the reference imports nothing of the program.
"""Nearest-neighbour energy model for the partition function.

Vienna-structured Turner model expressed directly in log-weight (score)
space: score = -dG / kT at 37C, so structure weight = exp(score sum).

The recursion structure (what loop classes exist and which table scores
each) follows the Vienna RNA package's energy evaluation — the engine the
reference outsources folding to (stem_kernel/common/bpmatrix.cpp:166-174,
common/pf_wrapper.cpp:15-36):

- canonical pair set {AU, UA, CG, GC, GU, UG} (optionally without GU/UG),
- helix stacking ``stack[p1, p2]``,
- hairpins: exact length table (<=30) + lxc log extrapolation, terminal
  mismatch for size > 3, terminal-AU penalty at size 3, special tri/tetra/
  hexaloop total-energy overrides,
- interior loops with the full Vienna case split: bulge-1 (keeps stacking),
  larger bulges (terminal-AU both ends), 1x1 / 2x1 / 2x2 special tables,
  1xn and 2x3 mismatch classes, generic interiors with NINIO asymmetry,
- multiloops: affine a + b*branches + c*unpaired with per-stem terminal
  mismatches (dangle model d2) and terminal-AU,
- exterior stems: terminal mismatch d2 (or single dangles at sequence ends)
  plus terminal-AU,
- ``--noLonelyPairs`` / ``--noClosingGU`` / ``--noGU`` gates.

Built-in numeric defaults are the transcribed Turner 2004 set
(fold.turner2004 — see its docstring for the exact-vs-constructed
provenance of each table).  Byte-faithful published tables load from a
Vienna ``.par`` v2.0 parameter file via :func:`load_params_file`; the DP
machinery itself is validated against an exhaustive structure-enumeration
oracle with randomized tables (which exercises every term), and the
shipped default model is pinned by golden BPP matrices in tests/golden/.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KT37 = 0.61633  # kcal/mol at 37C

# Pair type indexing: 0=CG 1=GC 2=GU 3=UG 4=AU 5=UA, -1 = not pairable.
# (Same order as Vienna's 1..6; their 7 = NN is dropped.)
# Base codes: A=0 C=1 G=2 U=3 (io.alphabet).
PAIR_TYPE = -np.ones((4, 4), dtype=np.int32)
PAIR_TYPE[1, 2] = 0  # CG
PAIR_TYPE[2, 1] = 1  # GC
PAIR_TYPE[2, 3] = 2  # GU
PAIR_TYPE[3, 2] = 3  # UG
PAIR_TYPE[0, 3] = 4  # AU
PAIR_TYPE[3, 0] = 5  # UA
N_PAIR = 6
# reversed pair type: REV_PAIR[pt(a,b)] = pt(b,a)
REV_PAIR = np.array([1, 0, 3, 2, 5, 4], dtype=np.int32)

MAXLOOP_TAB = 30  # exact loop-length tables up to this size (Vienna MAXLOOP)

# Turner 2004 stacking free energies (kcal/mol), rows = outer pair (i,j),
# cols = inner pair (i+1, j-1).  Order CG GC GU UG AU UA.
STACK_DG = np.array(
    [
        # CG     GC     GU     UG     AU     UA
        [-3.26, -2.36, -1.41, -2.11, -2.11, -2.08],  # CG
        [-3.42, -3.26, -2.51, -1.53, -2.35, -2.24],  # GC
        [-2.11, -1.41, -0.50, +0.30, -1.36, -1.27],  # GU
        [-2.51, -1.53, +0.30, -0.50, -1.00, -1.36],  # UG
        [-2.24, -2.08, -1.36, -1.00, -0.93, -1.10],  # AU
        [-2.35, -2.11, -1.27, -1.36, -1.33, -0.93],  # UA
    ]
)

TERMINAL_AU_DG = 0.50  # kcal/mol penalty per AU/UA/GU/UG helix end (Turner)


def _len_table(init: float, slope: float, min_size: int, ref_size: int) -> np.ndarray:
    """Loop-length score table [0..30] from the Jacobson-Stockmayer form.

    score(size) = init + slope * ln(size / ref_size); sizes below
    ``min_size`` are impossible (NEG handled by callers via -inf here).
    """
    sizes = np.arange(MAXLOOP_TAB + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = init + slope * np.log(np.maximum(sizes, ref_size) / ref_size)
    t[:min_size] = -np.inf
    return t


@dataclass
class EnergyParams:
    """All scores in log-weight units (dimensionless, already divided by kT).

    Table axis conventions (log-weights; higher = more favourable):
      stack[p_outer, p_inner]      inner pair read 5'->3' on the top strand
      terminal[p]                  helix-end penalty (negative for AU/GU)
      mismatch_h/i/i1n/i23/m/e[p, a, b]
                                   a = base 3' of the pair's 5' side,
                                   b = base 5' of the pair's 3' side
      dangle5[p, a] / dangle3[p, a]
      int11[p, q, a, b]            q = REVERSED inner pair; a = s[i+1], b = s[j-1]
      int21[p, q, a, b, c]         Vienna argument order (si1, sq1, sj1)
      int22[p, q, a, b, c, d]      (si1, sp1, sq1, sj1)
      hairpin_len/bulge_len/interior_len[size 0..30] + lxc extrapolation
      special_hairpins             {loop-with-closing-pair string: total score}
    """

    stack: np.ndarray  # (N_PAIR, N_PAIR)
    pair_bonus: np.ndarray  # (N_PAIR,) extra per-pair-type score
    terminal: np.ndarray  # (N_PAIR,) helix-end scores (0 for CG/GC)
    hairpin_len: np.ndarray  # (31,)
    bulge_len: np.ndarray  # (31,)
    interior_len: np.ndarray  # (31,)
    lxc: float  # log-extrapolation coefficient (score units, < 0)
    mismatch_h: np.ndarray  # (N_PAIR, 4, 4) hairpin terminal mismatch
    mismatch_i: np.ndarray  # (N_PAIR, 4, 4) generic interior mismatch
    mismatch_i1n: np.ndarray  # (N_PAIR, 4, 4) 1xn interior mismatch
    mismatch_i23: np.ndarray  # (N_PAIR, 4, 4) 2x3 interior mismatch
    mismatch_m: np.ndarray  # (N_PAIR, 4, 4) multiloop stem mismatch (d2)
    mismatch_e: np.ndarray  # (N_PAIR, 4, 4) exterior stem mismatch (d2)
    dangle5: np.ndarray  # (N_PAIR, 4)
    dangle3: np.ndarray  # (N_PAIR, 4)
    int11: np.ndarray  # (N_PAIR, N_PAIR, 4, 4)
    int21: np.ndarray  # (N_PAIR, N_PAIR, 4, 4, 4)
    int22: np.ndarray  # (N_PAIR, N_PAIR, 4, 4, 4, 4)
    ninio: float  # per-|n1-n2| asymmetry score (negative)
    ninio_max: float  # cap on the total asymmetry penalty (negative)
    ml_close: float  # multiloop closing (a)
    ml_branch: float  # per branch (b)
    ml_unpaired: float  # per unpaired base (c)
    special_hairpins: dict = field(default_factory=dict)  # seq -> total score
    max_interior: int = 30  # total unpaired bases in an interior/bulge loop
    # fast tier (--fast-fold): drop the int11/int21/int22/bulge-1 special
    # tables (constructed approximations anyway, BASELINE.md) and collapse
    # the four interior mismatch classes to two (generic interior, bulge)
    # — every loop still gets a principled generic-formula energy
    fast: bool = False
    min_hairpin: int = 3  # minimum unpaired bases in a hairpin
    no_gu: bool = False  # disallow GU/UG pairs entirely
    no_closing_gu: bool = False  # GU/UG may not close hairpin/multi loops
    no_lonely_pairs: bool = False  # isolated-pair gate (Vienna pf heuristic)
    # -- CONTRAfold-model switches (fold.contrafold; all default to the
    #    Vienna conventions above so Turner-model behaviour is unchanged) --
    ext_unpaired: float = 0.0  # score per unpaired exterior-loop base
    ext_paired: float = 0.0  # score per exterior-loop branch
    mismatch_all_hairpins: bool = False  # terminal mismatch at min-size too
    bulge1_no_stack: bool = False  # bulge-1: helix closings, no stack term
    bulge1_nuc: np.ndarray | None = None  # (4,) bulged-base identity score
    interior_explicit: np.ndarray | None = None  # (5, 5) total for n1,n2 <= 4
    interior_asym_table: np.ndarray | None = None  # per-|n1-n2| asymmetry

    # legacy scalar accessors kept for the simple text parameter format
    @property
    def hairpin_init(self) -> float:
        return float(self.hairpin_len[3])

    @property
    def interior_asym(self) -> float:
        return self.ninio


def fast_variant(params: EnergyParams) -> EnergyParams:
    """The --fast-fold tier of a parameter set (params.fast docstring)."""
    import dataclasses

    return dataclasses.replace(params, fast=True)


def default_params() -> EnergyParams:
    """The shipped default model: the transcribed Turner 2004 set.

    See fold.turner2004 for the full provenance statement.  The reference's
    folding layer is Vienna pf_fold under the same published parameter set
    (stem_kernel/common/bpmatrix.cpp:166-174)."""
    from .turner2004 import turner2004_params

    return turner2004_params()


def bare_params() -> EnergyParams:
    """Minimal Turner-flavoured defaults (stacking + loop shapes only;
    mismatch/dangle tables zero).  Base model for the simple text parameter
    format, where files specify deltas over an intentionally plain model."""
    kt = KT37
    terminal = np.zeros(N_PAIR)
    terminal[2:] = -TERMINAL_AU_DG / kt  # GU UG AU UA
    p = EnergyParams(
        stack=(-STACK_DG / kt).astype(np.float64),
        pair_bonus=np.zeros(N_PAIR),
        terminal=terminal,
        hairpin_len=_len_table(-5.7 / kt, -1.75, 3, 3),
        bulge_len=_len_table(-3.8 / kt, -1.75, 1, 1),
        interior_len=_len_table(-1.7 / kt, -1.75, 2, 2),
        lxc=-107.856 / 100.0 / kt,  # Vienna's lxc37 in score units
        mismatch_h=np.zeros((N_PAIR, 4, 4)),
        mismatch_i=np.zeros((N_PAIR, 4, 4)),
        mismatch_i1n=np.zeros((N_PAIR, 4, 4)),
        mismatch_i23=np.zeros((N_PAIR, 4, 4)),
        mismatch_m=np.zeros((N_PAIR, 4, 4)),
        mismatch_e=np.zeros((N_PAIR, 4, 4)),
        dangle5=np.zeros((N_PAIR, 4)),
        dangle3=np.zeros((N_PAIR, 4)),
        int11=np.zeros((N_PAIR, N_PAIR, 4, 4)),
        int21=np.zeros((N_PAIR, N_PAIR, 4, 4, 4)),
        int22=np.zeros((N_PAIR, N_PAIR, 4, 4, 4, 4)),
        ninio=-0.6 / kt,
        ninio_max=-3.0 / kt,
        ml_close=-3.4 / kt,
        ml_branch=-0.4 / kt,
        ml_unpaired=-0.0 / kt,
    )
    _fill_special_interior_defaults(p)
    return p


def _fill_special_interior_defaults(p: EnergyParams) -> None:
    """Initialize int11/int21/int22 from the generic interior formula so the
    default model is self-consistent; a .par file replaces them with the
    published tables."""
    i11 = p.interior_len[2]
    i21 = p.interior_len[3] + max(p.ninio, p.ninio_max)
    i22 = p.interior_len[4]
    p.int11 = np.full((N_PAIR, N_PAIR, 4, 4), i11)
    p.int21 = np.full((N_PAIR, N_PAIR, 4, 4, 4), i21)
    p.int22 = np.full((N_PAIR, N_PAIR, 4, 4, 4, 4), i22)


def loop_len_score(table: np.ndarray, lxc: float, size) -> np.ndarray:
    """Loop length score: exact table to 30, lxc*ln(size/30) beyond."""
    size = np.asarray(size)
    small = table[np.clip(size, 0, MAXLOOP_TAB)]
    with np.errstate(divide="ignore", invalid="ignore"):
        big = table[MAXLOOP_TAB] + lxc * np.log(
            np.maximum(size, MAXLOOP_TAB) / MAXLOOP_TAB
        )
    return np.where(size <= MAXLOOP_TAB, small, big)


def hairpin_score(params: EnergyParams, size: np.ndarray) -> np.ndarray:
    """Length part of the hairpin score (mismatch/terminal handled by the
    engines per closing pair)."""
    out = loop_len_score(params.hairpin_len, params.lxc, size)
    return np.where(np.asarray(size) >= params.min_hairpin, out, -np.inf)


def interior_score(params: EnergyParams, n1: np.ndarray, n2: np.ndarray) -> np.ndarray:
    """Length + asymmetry part of a bulge/interior loop with n1/n2 unpaired.

    (0, 0) is helix stacking, handled separately.  Terminal/mismatch factors
    are applied by the engines per pair context (they depend on sequence).
    """
    n1 = np.asarray(n1)
    n2 = np.asarray(n2)
    total = n1 + n2
    bulge = loop_len_score(params.bulge_len, params.lxc, total)
    asym = np.maximum(params.ninio * np.abs(n1 - n2), params.ninio_max)
    interior = loop_len_score(params.interior_len, params.lxc, total) + asym
    return np.where((n1 == 0) | (n2 == 0), bulge, interior)
