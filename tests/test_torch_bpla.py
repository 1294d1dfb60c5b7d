"""Port parity: the BPLA / LA family against the JAX package.

The same numpy inputs go through the JAX package (the reference; its Pallas
kernels in interpret mode, as tests/test_bpla.py runs them) and the PyTorch
port, which runs its plain torch versions here (CPU tensors).  Tolerances are
those tests/test_bpla.py holds the same functions to, or tighter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.io.profile import Alignment as JAlignment
from stem_kernel_tpu.models import bpla as jb
from stem_kernel_tpu.models.featurize import bpla_features as j_bpla_features
from stem_kernel_tpu.ops import pallas_la as jp
from stem_kernel_tpu.ops import recurrence as jr
from stem_kernel_torch.convert import bpla_kernel_from_numpy
from stem_kernel_torch.gram.engine import PairKernelEngine
from stem_kernel_torch.io.profile import Alignment
from stem_kernel_torch.models import bpla as tb
from stem_kernel_torch.models.blosum_data import BLOSUM62
from stem_kernel_torch.models.featurize import bpla_features
from stem_kernel_torch.ops import la as tl
from stem_kernel_torch.ops import recurrence as tr
from stem_kernel_torch.utils.tracing import counters

PARAMS = (0.11, -8.0, -0.75)  # beta, gap, ext
ALPHA = 4.5


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _calls(wrapper, kind: str = "calls") -> int:
    """The wrapper's launches (``kind`` "calls") or those on a lane geometry
    ("lanes"), as the program counts them."""
    return counters().get(f"la.{wrapper.__name__}.{kind}", 0)


def _profiles(rng, b, n, k=4, empty=None):
    p = rng.uniform(size=(b, n, k)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    if empty is not None:
        p[empty] = 0.0  # an all-gap column: the LAScore 0.0 fallback
    return p


def _features(rng, b, n, lengths):
    prof = _profiles(rng, b, n, empty=(0, 4))
    pl = rng.uniform(0, 0.7, (b, n)).astype(np.float32)
    pr = rng.uniform(0, 0.7, (b, n)).astype(np.float32)
    pu = np.sqrt(np.clip(1.0 - pl**2 - pr**2, 0, None)).astype(np.float32)
    return {"profile": prof, "p_left": pl, "p_right": pr, "p_unpair": pu,
            "length": np.asarray(lengths, np.int32)}


def test_la_score_matrix_and_parts_match_jax():
    rng = np.random.default_rng(3)
    x = _features(rng, 3, 11, [11, 7, 2])
    y = _features(rng, 3, 9, [9, 9, 4])
    table = rng.normal(size=(4, 4)).astype(np.float32)
    want = np.asarray(jb.la_score_matrix(*_j(x["profile"], y["profile"], table)))
    got = tb.la_score_matrix(*_t(x["profile"], y["profile"], table)).numpy()
    assert got[0, 4].tolist() == [0.0] * 9  # the empty column
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    keys = ("profile", "p_left", "p_right", "p_unpair")
    args = [x[k] for k in keys] + [y[k] for k in keys] + [table]
    j_wp, j_wu = jb.bpla_score_parts(*_j(*args))
    t_wp, t_wu = tb.bpla_score_parts(*_t(*args))
    np.testing.assert_allclose(t_wp.numpy(), np.asarray(j_wp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_wu.numpy(), np.asarray(j_wu), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("side", ["x", "y"])
def test_bpla_factors_match_jax(side):
    rng = np.random.default_rng(4)
    d = _features(rng, 3, 11, [11, 5, 1])
    table = rng.normal(size=(4, 4)).astype(np.float32)
    args = [d[k] for k in ("profile", "p_left", "p_right", "p_unpair")] + [table]
    want = np.asarray(jb.bpla_factors(*_j(*args), side=side))
    got = tb.bpla_factors(*_t(*args), side=side).numpy()
    assert got.shape == (3, 11, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[0, 4, 2:], 0.0)  # empty column


def test_bpla_profiles_and_features_match_jax():
    rng = np.random.default_rng(5)
    seqs = ["gggaaaccc", "gcgcaaagcgcuu", "acgu-acguaacg"]
    bpps = []
    for s in seqs:
        n = len(s)
        bpps.append(np.triu(rng.uniform(0, 2.0 / n, (n, n)), 1))
    for bpp in bpps:
        for a, b in zip(tb.bpla_profiles(bpp), jb.bpla_profiles(bpp)):
            np.testing.assert_array_equal(a, b)
    got = bpla_features([Alignment(rows=[s]) for s in seqs], bpps)
    want = j_bpla_features([JAlignment(rows=[s]) for s in seqs], bpps)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_RECURRENCE_CASES = [  # (kind, reverse, weight, length): the BPLA scan weights
    (kind, reverse, -0.0825 if kind == "logsumexp" else -0.75, 70)  # at L=70, and
    for kind in ("logsumexp", "maxplus") for reverse in (False, True)
] + [(kind, reverse, -15.0, 300)  # the PHMM's in-row IY weight on a 300-column row
     for kind in ("logsumexp", "maxplus") for reverse in (False, True)]


@pytest.mark.parametrize(
    "kind,reverse,a,length", _RECURRENCE_CASES,
    ids=[f"{k}-{r}" + ("" if n == 70 else f"-phmm{n}") for k, r, _, n in _RECURRENCE_CASES])
def test_recurrences_match_jax(kind, reverse, a, length):
    rng = np.random.default_rng(6)
    b = rng.normal(scale=3.0, size=(3, 2, length)).astype(np.float32)
    b[0, 0, 10:20] = tb.NEG_LARGE
    want = np.asarray(getattr(jr, f"{kind}_recurrence")(a, jnp.asarray(b), reverse=reverse))
    got = getattr(tr, f"{kind}_recurrence")(a, torch.as_tensor(b), reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ragged_scores(rng, b=5, lx=9, ly=7, lo=-3.0, hi=4.0):
    s = rng.uniform(lo, hi, (b, lx, ly)).astype(np.float32)
    return s, np.array([9, 6, 3, 9, 1], np.int32)[:b], np.array([7, 7, 2, 5, 1], np.int32)[:b]


@pytest.mark.parametrize("kind", ["exp", "log", "max"])
def test_scans_match_jax(kind):
    rng = np.random.default_rng(7)
    s, lx, ly = _ragged_scores(rng)
    mask = np.asarray(jb.pair_mask(*_j(lx), 9, *_j(ly), 7))
    assert np.array_equal(tb.pair_mask(*_t(lx), 9, *_t(ly), 7).numpy(), mask)
    if kind == "max":
        want = np.asarray(jb.local_alignment_max(*_j(s, mask), *PARAMS[1:]))
        got = tb.local_alignment_max(*_t(s, mask), *PARAMS[1:]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    fn = f"local_alignment_{kind}"
    want = np.asarray(getattr(jb, fn)(*_j(s, mask), *PARAMS))
    got = getattr(tb, fn)(*_t(s, mask), *PARAMS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _case_materialised(kind, two):
    """(port plain value, JAX interpret value, rtol) for K4/K5."""
    rng = np.random.default_rng(8)
    if kind == "long":  # exp space overflows here; the log closure stays finite
        s = np.full((2, 160, 160), 15.0, np.float32)
        lx, ly = np.array([160, 120], np.int32), np.array([160, 160], np.int32)
        want = jp.la_log_pallas(*_j(s, lx, ly), *PARAMS, block_b=8, interpret=True)
        got = tl.la_log_reference(*_t(s, lx, ly), *PARAMS)
        return got, want, 1e-4
    s, lx, ly = _ragged_scores(rng, lo=-3.0, hi=2.0 if kind == "exp" else 4.0)
    kw_j, kw_t = {}, {}
    if two:
        s = rng.uniform(0.0, 1.0, s.shape).astype(np.float32)
        s2 = rng.uniform(-2.0, 2.0, s.shape).astype(np.float32)
        kw_j = {"scores2": jnp.asarray(s2), "alpha": ALPHA}
        kw_t = {"scores2": torch.as_tensor(s2), "alpha": ALPHA}
    jfn = jp.la_exp_pallas if kind == "exp" else jp.la_log_pallas
    tfn = tl.la_exp_reference if kind == "exp" else tl.la_log_reference
    want = jfn(*_j(s, lx, ly), *PARAMS, block_b=8, interpret=True, **kw_j)
    return tfn(*_t(s, lx, ly), *PARAMS, **kw_t), want, 2e-4 if two else 1e-4


def _case_factored(kind):
    """(port plain value, JAX interpret value, rtol) for K2/K3, Lx != Ly."""
    rng = np.random.default_rng(7)
    fx = (rng.normal(size=(5, 21, 6)) * 0.4).astype(np.float32)
    fy = (rng.normal(size=(5, 17, 6)) * 0.4).astype(np.float32)
    lx = np.array([21, 13, 3, 21, 1], np.int32)
    ly = np.array([17, 17, 2, 9, 1], np.int32)
    jfn = jp.la_exp_factored if kind == "exp" else jp.la_log_factored
    tfn = tl.la_exp_factored_reference if kind == "exp" else tl.la_log_factored_reference
    want = jfn(*_j(fx, fy, lx, ly), ALPHA, *PARAMS, block_b=8, interpret=True)
    return tfn(*_t(fx, fy, lx, ly), ALPHA, *PARAMS), want, 1e-4


_EDGE_LY = (31, 32, 33, 64, 65, 128, 129)  # the log kernels' chunk and lane-geometry edges
_LOG_EDGE_CASES = ([f"K2 rank {r} Ly={w}" for w in _EDGE_LY for r in (2, 6)]
                   + [f"K5 Ly={w}" for w in _EDGE_LY]
                   + ["K5 two slabs Ly=65", "K5 two slabs Ly=129", "K2 drop", "K5 drop",
                      "K2 long"])


def _log_edge_operands(case):
    """(numpy operands, scores2) of a log-kernel case: K2 factors
    (fx, fy, lx, ly) or K5 scores (s, lx, ly).  Edge widths have Lx != Ly
    and ragged lengths that include the full pad; "drop" scores its first 15
    rows at about +3 a cell and the rest 40+ nats lower, so that the gap
    state carries mass far below the later rows' maxima; "long" is the
    long-score case (15 a cell, 160 x 160, log K 326.0) as factors."""
    rng = np.random.default_rng(sum(map(ord, case)))
    beta = PARAMS[0]
    if "drop" in case:
        b, nx, ny, strong = 3, 50, 40, 15
        lx, ly = np.array([50, 41, 50], np.int32), np.array([40, 40, 33], np.int32)
        if case.startswith("K2"):
            fx = rng.normal(size=(b, nx, 6)) * 0.3
            fy = rng.normal(size=(b, ny, 6)) * 0.3
            fx[:, :strong, 2] = 3.0 / beta
            fx[:, strong:, 2] = -rng.uniform(40.0, 45.0, (b, nx - strong)) / beta
            fy[:, :, 2] = rng.uniform(0.9, 1.1, (b, ny))
            return (fx.astype(np.float32), fy.astype(np.float32), lx, ly), None
        s = rng.normal(size=(b, nx, ny)) * 5.0
        s[:, :strong] += 3.0 / beta
        s[:, strong:] -= 42.0 / beta
        return (s.astype(np.float32), lx, ly), None
    if case == "K5 long":  # the case of test_plain_versions_match_pallas_interpret[K5 log long]
        s = np.full((2, 160, 160), 15.0, np.float32)
        return (s, np.array([160, 120], np.int32), np.array([160, 160], np.int32)), None
    if "long" in case:
        fx = np.zeros((2, 160, 2), np.float32)
        fx[:, :, 0] = 15.0 / ALPHA
        fy = np.zeros((2, 160, 2), np.float32)
        fy[:, :, 0] = 1.0
        return (fx, fy, np.array([160, 120], np.int32), np.array([160, 160], np.int32)), None
    w = int(case.split("Ly=")[1])
    rank = 2 if "rank 2" in case else 6
    lx_max = w + 9 if rank == 2 else max(w - 7, 3)
    lx = np.array([lx_max, rng.integers(1, lx_max + 1), rng.integers(1, lx_max + 1), 1], np.int32)
    ly = np.array([w, rng.integers(1, w + 1), 1, w], np.int32)
    if case.startswith("K2"):
        fx, fy = ((rng.normal(size=(4, n, rank)) * 0.5).astype(np.float32) for n in (lx_max, w))
        return (fx, fy, lx, ly), None
    s = rng.uniform(-20.0, 25.0, (4, lx_max, w)).astype(np.float32)
    s2 = rng.uniform(-10.0, 10.0, s.shape).astype(np.float32) if "two slabs" in case else None
    return (s, lx, ly), s2


def _case_log_edge(case):
    """(port plain value, JAX interpret value, rtol) of a log-kernel case."""
    ops, s2 = _log_edge_operands(case)
    if case.startswith("K2"):
        want = jp.la_log_factored(*_j(*ops), ALPHA, *PARAMS, block_b=8, interpret=True)
        return tl.la_log_factored_reference(*_t(*ops), ALPHA, *PARAMS), want, 1e-4
    kw_j, kw_t = {}, {}
    if s2 is not None:
        kw_j = {"scores2": jnp.asarray(s2), "alpha": ALPHA}
        kw_t = {"scores2": torch.as_tensor(s2), "alpha": ALPHA}
    want = jp.la_log_pallas(*_j(*ops), *PARAMS, block_b=8, interpret=True, **kw_j)
    return tl.la_log_reference(*_t(*ops), *PARAMS, **kw_t), want, 1e-4


_EXP_EDGE_CASES = ([f"K3 rank {r} Ly={w}" for w in _EDGE_LY for r in (2, 6)]
                   + [f"K4 Ly={w}" for w in _EDGE_LY]
                   + ["K4 two slabs Ly=65", "K4 two slabs Ly=129"])
# the exp lane route's widest width, Lx != Ly, log emissions -8..-3 so that K stays finite
_EXP_WIDE_CASES = ["K3 300x500", "K4 300x500", "K4 two slabs 300x500"]
_EXP_CASES = _EXP_EDGE_CASES + _EXP_WIDE_CASES


def _overflow_emissions(rng):
    """(log emissions (8, 40, 50), lx, ly): pairs 0-2 finite; 3 emits +3 a
    cell, so the closure passes the largest f32; 4 has one cell of 100,
    whose exp is inf; 5 one cell of 87.5 (e = 1e38) among cells of -8..-3,
    finite; 6 emits 4..6 on 3 x 4 cells, finite; 7 emits +1 with ly = 0."""
    le = rng.uniform(-3.0, -1.0, (8, 40, 50))
    le[3] = 3.0
    le[4, 20, 30] = 100.0
    le[5] = rng.uniform(-8.0, -3.0, (40, 50))
    le[5, 10, 10] = 87.5
    le[6] = rng.uniform(4.0, 6.0, (40, 50))
    le[7] = 1.0
    lx = np.array([40, 31, 17, 40, 40, 40, 3, 40], np.int32)
    ly = np.array([50, 50, 26, 50, 50, 50, 4, 0], np.int32)
    return le, lx, ly


def _exp_operands(case):
    """(numpy operands, scores2) of an exp-kernel case under PARAMS (and
    ALPHA): K3 factors (fx, fy, lx, ly) or K4 scores (s, lx, ly).  Edge
    widths have Lx != Ly, ragged lengths that include the full pad and log
    emissions in -3..-1 (K up to about 1e16); "300x500" has log emissions in
    -8..-3; "overflow" is the batch of :func:`_overflow_emissions`.  K3 carries
    a column's emission in slot 2 (slot 0 at rank 2) beside noise in the
    others, and the overflow batch's single cells in slot 3; K4's two slabs
    carry half of it each."""
    rng = np.random.default_rng(sum(map(ord, case)))
    beta = PARAMS[0]
    if "overflow" in case:
        le, lx, ly = _overflow_emissions(rng)
        if case.startswith("K4"):
            return ((le / beta).astype(np.float32), lx, ly), None
        fx, fy = np.zeros((8, 40, 6)), np.zeros((8, 50, 6))
        fx[:, :, 2] = 1.0
        fy[:, :, 2] = le[:, 0, :] / beta
        for p, (i, j) in ((4, (20, 30)), (5, (10, 10))):
            fx[p, i, 3] = 1.0
            fy[p, j, 3] = (le[p, i, j] - le[p, 0, j]) / beta
        return (fx.astype(np.float32), fy.astype(np.float32), lx, ly), None
    if "300x500" in case:
        lo, hi, lx_max, w = -8.0, -3.0, 300, 500
        lx = np.array([300, 211, 57, 300], np.int32)
        ly = np.array([500, 500, 333, 1], np.int32)
    else:
        w = int(case.split("Ly=")[1])
        lo, hi, lx_max = -3.0, -1.0, w + 9
        lx = np.array([lx_max, rng.integers(1, lx_max + 1), rng.integers(1, lx_max + 1), 1],
                      np.int32)
        ly = np.array([w, rng.integers(1, w + 1), 1, w], np.int32)
    if case.startswith("K3"):
        rank = 2 if "rank 2" in case else 6
        k, coef = (0, ALPHA * beta) if rank == 2 else (2, beta)
        fx = rng.normal(size=(4, lx_max, rank)) * 0.3
        fy = rng.normal(size=(4, w, rank)) * 0.3
        fx[:, :, k] = rng.uniform(0.9, 1.1, (4, lx_max))
        fy[:, :, k] = rng.uniform(lo, hi, (4, w)) / coef
        return (fx.astype(np.float32), fy.astype(np.float32), lx, ly), None
    if "two slabs" not in case:
        return ((rng.uniform(lo, hi, (4, lx_max, w)) / beta).astype(np.float32), lx, ly), None
    s, s2 = ((rng.uniform(lo, hi, (4, lx_max, w)) / (2 * c)).astype(np.float32)
             for c in (ALPHA * beta, beta))
    return (s, lx, ly), s2


def _case_exp(case):
    """(port plain value, JAX interpret value, rtol) of an exp-kernel case."""
    ops, s2 = _exp_operands(case)
    if case.startswith("K3"):
        want = jp.la_exp_factored(*_j(*ops), ALPHA, *PARAMS, block_b=8, interpret=True)
        return tl.la_exp_factored_reference(*_t(*ops), ALPHA, *PARAMS), want, 1e-4
    kw_j, kw_t = {}, {}
    if s2 is not None:
        kw_j = {"scores2": jnp.asarray(s2), "alpha": ALPHA}
        kw_t = {"scores2": torch.as_tensor(s2), "alpha": ALPHA}
    want = jp.la_exp_pallas(*_j(*ops), *PARAMS, block_b=8, interpret=True, **kw_j)
    return (tl.la_exp_reference(*_t(*ops), *PARAMS, **kw_t), want,
            2e-4 if s2 is not None else 1e-4)


@pytest.mark.parametrize("case", ["K2 log factored", "K3 exp factored", "K4 exp",
                                  "K4 exp affine", "K5 log", "K5 log affine",
                                  "K5 log long", *_LOG_EDGE_CASES, *_EXP_CASES])
def test_plain_versions_match_pallas_interpret(case):
    """Each kernel's plain version against its Pallas function (interpret);
    the log kernels also at the cases of :func:`_log_edge_operands`, the exp
    kernels at those of :func:`_exp_operands`."""
    kind = "exp" if " exp" in case else "log"
    if case in _LOG_EDGE_CASES:
        got, want, rtol = _case_log_edge(case)
    elif case in _EXP_CASES:
        got, want, rtol = _case_exp(case)
    elif "factored" in case:
        got, want, rtol = _case_factored(kind)
    else:
        got, want, rtol = _case_materialised("long" if "long" in case else kind,
                                             "affine" in case)
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol)


def _long_case(kernel, rng):
    """Operands with Ly = 1500 > 1024 columns and Lx != Ly: rank-6 factors
    (K2) or a score slab low enough that exp space stays finite (K4)."""
    lx = np.array([24, 17], np.int32)
    ly = np.array([1500, 1100], np.int32)
    if kernel == "K2":
        fx = (rng.normal(size=(2, 24, 6)) * 0.4).astype(np.float32)
        fy = (rng.normal(size=(2, 1500, 6)) * 0.4).astype(np.float32)
        return (fx, fy, lx, ly)
    return (rng.uniform(-8.0, -3.0, (2, 24, 1500)).astype(np.float32), lx, ly)


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_plain_versions_take_ly_1500(kernel):
    """The CPU wrappers take Ly past the one-warp kernel's 1024 columns,
    against the Pallas functions in interpret mode (K2 la_log_factored,
    K4 la_exp_pallas), within the bands of the short cases."""
    ops = _long_case(kernel, np.random.default_rng(13))
    if kernel == "K2":
        got = tl.la_log_factored(*_t(*ops), ALPHA, *PARAMS).numpy()
        want = np.asarray(jp.la_log_factored(*_j(*ops), ALPHA, *PARAMS, block_b=8,
                                             interpret=True))
    else:
        got = tl.la_exp(*_t(*ops), *PARAMS).numpy()
        want = np.asarray(jp.la_exp_pallas(*_j(*ops), *PARAMS, block_b=8, interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_dispatchers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(9)
    s, lx, ly = _ragged_scores(rng, lo=-3.0, hi=2.0)
    s2 = rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
    args = _t(s, lx, ly)
    before = [_calls(w) for w in (tl.la_exp, tl.la_log)]
    np.testing.assert_array_equal(tl.la_exp_auto(*args, *PARAMS).numpy(),
                                  tl.la_exp_reference(*args, *PARAMS).numpy())
    np.testing.assert_array_equal(tl.la_log_auto(*args, *PARAMS).numpy(),
                                  tl.la_log_reference(*args, *PARAMS).numpy())
    aff = tl.la_log_affine_auto(args[0], torch.as_tensor(s2), args[1], args[2], ALPHA, *PARAMS)
    want = tl.la_log_reference(*args, *PARAMS, scores2=torch.as_tensor(s2), alpha=ALPHA)
    np.testing.assert_array_equal(aff.numpy(), want.numpy())
    assert [_calls(w) for w in (tl.la_exp, tl.la_log)] == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["int64 lengths", "rank 7", "rank 1", "strided",
                                 "int64 y lengths", "scores2 shape"])
def test_wrappers_reject_bad_operands(bad):
    fx = torch.zeros(2, 5, 6)
    fy = torch.zeros(2, 4, 6)
    lx = torch.tensor([5, 3], dtype=torch.int32)
    ly = torch.tensor([4, 1], dtype=torch.int32)
    s = torch.zeros(2, 5, 4)
    calls = {
        "int64 lengths": lambda: tl.la_log_factored(fx, fy, lx.long(), ly, ALPHA, *PARAMS),
        "rank 7": lambda: tl.la_exp_factored(torch.zeros(2, 5, 7), torch.zeros(2, 4, 7),
                                             lx, ly, ALPHA, *PARAMS),
        "rank 1": lambda: tl.la_log_factored(fx[..., :1].contiguous(), fy[..., :1].contiguous(),
                                             lx, ly, ALPHA, *PARAMS),
        "strided": lambda: tl.la_exp(s.transpose(1, 2), lx, ly, *PARAMS),
        "int64 y lengths": lambda: tl.la_exp(s, lx, ly.long(), *PARAMS),
        "scores2 shape": lambda: tl.la_log(s, lx, ly, *PARAMS, scores2=torch.zeros(2, 5, 3)),
    }
    with pytest.raises(ValueError):
        calls[bad]()


def _kernel_pair(**kw):
    """The JAX BPLAKernel and the port's, built from one numpy table."""
    table = kw.pop("table", jb.DEFAULT_BPLA_SCORE_TABLE)
    return (jb.BPLAKernel(table, **kw),
            bpla_kernel_from_numpy(table, device="cpu", **kw))


@pytest.mark.parametrize("variant", ["default", "noBP", "SW", "rank 7 table"])
def test_bpla_kernel_module_matches_jax(variant):
    """forward and log_value of BPLAKernel (the port takes the factored
    plain versions for rank <= 6, the affine ones above) against JAX."""
    rng = np.random.default_rng(10)
    x = _features(rng, 4, 12, [12, 9, 3, 12])
    y = _features(rng, 4, 10, [10, 10, 6, 1])
    kw = {"default": {}, "noBP": {"no_bp": True}, "SW": {"sw": True},
          "rank 7 table": {"table": rng.normal(size=(5, 5)).astype(np.float32)}}[variant]
    if variant == "rank 7 table":
        x["profile"] = _profiles(rng, 4, 12, k=5)
        y["profile"] = _profiles(rng, 4, 10, k=5)
    jk, tk = _kernel_pair(**kw)
    assert tk._factored_ok == (variant != "rank 7 table")
    jx, jy = ({k: jnp.asarray(v) for k, v in d.items()} for d in (x, y))
    tx, ty = ({k: torch.as_tensor(v) for k, v in d.items()} for d in (x, y))
    rtol = 1e-5 if variant == "SW" else 1e-4
    np.testing.assert_allclose(tk(tx, ty).numpy(), np.asarray(jk(jx, jy)), rtol=rtol)
    if variant != "SW":
        np.testing.assert_allclose(tk.log_value(tx, ty).numpy(),
                                   np.asarray(jk.log_value(jx, jy)), rtol=rtol)


@pytest.mark.parametrize("kernel", ["bpla log", "protein exp"])
def test_gram_is_bit_identical_across_batch_sizes(kernel):
    rng = np.random.default_rng(11)
    n = 7
    if kernel == "bpla log":
        feats = _features(rng, n, 24, rng.integers(5, 25, n))
        kern = tb.BPLAKernel()
        fn, log_values = kern.log_value, True
    else:
        feats = {"profile": _profiles(rng, n, 16, k=23),
                 "length": rng.integers(4, 17, n).astype(np.int32)}
        table = torch.as_tensor(BLOSUM62)

        def fn(x, y):
            s = tb.la_score_matrix(x["profile"], y["profile"], table)
            return tl.la_exp_auto(s, x["length"], y["length"], 0.11, -10.0, -1.0)

        log_values = False
    grams = [PairKernelEngine(fn, feats, device="cpu", batch_size=bs,
                              log_values=log_values).gram(normalize=True)
             for bs in (3, 256)]
    assert np.isfinite(grams[0]).all()
    assert np.array_equal(grams[0], grams[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2 la_log_factored", "K3 la_exp_factored",
                                    "K4 la_exp", "K5 la_log"])
def test_cuda_kernel_matches_plain_version(kernel):
    """Each hand-written kernel against its plain version on the card:
    Lx != Ly, ragged lengths, and a pair's value alone equal to its value
    inside the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(12)
    b, lx_max, ly_max = 9, 37, 70
    lx = torch.as_tensor(rng.integers(0, lx_max + 1, b).astype(np.int32)).cuda()
    ly = torch.as_tensor(rng.integers(1, ly_max + 1, b).astype(np.int32)).cuda()
    if "factored" in kernel:
        fx = torch.as_tensor((rng.normal(size=(b, lx_max, 6)) * 0.3).astype(np.float32)).cuda()
        fy = torch.as_tensor((rng.normal(size=(b, ly_max, 6)) * 0.3).astype(np.float32)).cuda()
        args = (fx, fy, lx, ly, ALPHA, *PARAMS)
        wrapper = tl.la_log_factored if "log" in kernel else tl.la_exp_factored
        first3 = (fx[:3].contiguous(), fy[:3].contiguous(), lx[:3], ly[:3], ALPHA, *PARAMS)
        kw = {}
    else:
        s = torch.as_tensor(rng.uniform(-3, 2, (b, lx_max, ly_max)).astype(np.float32)).cuda()
        s2 = torch.as_tensor(rng.uniform(-1, 1, (b, lx_max, ly_max)).astype(np.float32)).cuda()
        args = (s, lx, ly, *PARAMS)
        wrapper = tl.la_log if "log" in kernel else tl.la_exp
        first3 = (s[:3].contiguous(), lx[:3], ly[:3], *PARAMS)
        kw = {"scores2": s2, "alpha": 0.5}
    reference = getattr(tl, f"{wrapper.__name__}_reference")
    launches = _calls(wrapper)
    got = wrapper(*args).cpu().numpy()
    torch.cuda.synchronize()
    assert _calls(wrapper) == launches + 1
    want = reference(*args).cpu().numpy()
    if "log" in kernel:
        np.testing.assert_allclose(got, want, atol=3e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3)
    assert np.array_equal(wrapper(*first3).cpu().numpy(), got[:3])
    if kw:
        got = wrapper(*args, **kw).cpu().numpy()
        want = reference(*args, **kw).cpu().numpy()
        np.testing.assert_allclose(got, want, **({"atol": 3e-3} if "log" in kernel
                                                 else {"rtol": 1e-3}))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*_LOG_EDGE_CASES, "K5 long"])
def test_cuda_log_kernel_matches_plain_version(case):
    """The log kernels K2 and K5 on the card against their plain versions
    at the cases of :func:`_log_edge_operands`, within the 3e-3 gate: on the
    route's lane geometry (one launch, counted), on every other geometry
    that holds the width and on the one-warp kernel; and the first 3 pairs alone
    equal to their values inside the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    ops, s2 = _log_edge_operands(case)
    ops = [t.cuda() for t in _t(*ops)]
    if case.startswith("K2"):
        wrapper, at = tl.la_log_factored, tl.la_log_factored_at
        reference = tl.la_log_factored_reference
        scalars, kw, width = (ALPHA, *PARAMS), {}, ops[1].shape[1]
    else:
        wrapper, at, reference = tl.la_log, tl.la_log_at, tl.la_log_reference
        kw = {} if s2 is None else {"scores2": torch.as_tensor(s2).cuda(), "alpha": ALPHA}
        scalars, width = PARAMS, ops[0].shape[2]
    want = reference(*ops, *scalars, **kw).cpu().numpy()
    launches = _calls(wrapper)
    got = wrapper(*ops, *scalars, **kw).cpu().numpy()
    assert _calls(wrapper) == launches + 1
    np.testing.assert_allclose(got, want, atol=3e-3)
    kw3 = {k: v[:3].contiguous() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    alone = wrapper(*[o[:3].contiguous() for o in ops], *scalars, **kw3).cpu().numpy()
    assert np.array_equal(alone, got[:3])
    for geo in [(0, 0)] + [g for g in tl.LOG_GEOMETRIES if g[0] * g[1] >= width]:
        np.testing.assert_allclose(at(geo, *ops, *scalars, **kw).cpu().numpy(), want, atol=3e-3)


def test_la_log_numerics_models_start_from_the_plain_version():
    """la_log_numerics.py's closure with no change is K2's plain version bit
    for bit, and each model of a lane-kernel step stays near it on short
    ragged pairs."""
    import la_log_numerics as ln

    rng = np.random.default_rng(7)
    fx, fy = (torch.as_tensor((rng.normal(size=(4, n, 6)) * 0.5).astype(np.float32))
              for n in (40, 48))
    lx = torch.tensor([40, 31, 12, 1], dtype=torch.int32)
    ly = torch.tensor([48, 40, 5, 48], dtype=torch.int32)
    sc = tl._scalars(*PARAMS)
    emit = tl._factored_emitter(fx, fy, ALPHA, sc)
    plain = tl.la_log_factored_reference(fx, fy, lx, ly, ALPHA, *PARAMS)
    assert torch.equal(ln.log_closure(emit, lx, ly, 40, 48, sc), plain)
    for variant in ("exp2", "exp_sub", "softplus3", "log2", "exp_sub+softplus3+log2", "f64"):
        got = ln.log_closure(emit, lx, ly, 40, 48, sc, variant).double().numpy()
        np.testing.assert_allclose(got, plain.double().numpy(), atol=1e-4)


def test_log_route_covers_every_width():
    """Every padded shape up to LANE_MAX_LEN rows and columns takes a lane
    geometry the library holds and that holds the width; longer or wider
    ones take the one-warp kernel."""
    for w in range(1, tl.LANE_MAX_LEN + 1):
        lanes, cols = tl.log_route(tl.LANE_MAX_LEN, w)
        assert (lanes, cols) in tl.LOG_GEOMETRIES and lanes * cols >= w
    for rows, w in ((1, tl.LANE_MAX_LEN + 1), (1, 1024), (1, tl.MAX_LY),
                    (tl.LANE_MAX_LEN + 1, 120), (5000, 1)):
        assert tl.log_route(rows, w) == (0, 0)


@pytest.mark.parametrize("bad", ["K2 on the CPU", "K5 on the CPU", "too narrow",
                                 "not in the library"])
def test_lane_geometry_launches_are_checked(bad):
    fx, fy = torch.zeros(2, 5, 6), torch.zeros(2, 4, 6)
    lx = torch.tensor([5, 3], dtype=torch.int32)
    ly = torch.tensor([4, 1], dtype=torch.int32)
    calls = {
        "K2 on the CPU": lambda: tl.la_log_factored_at((32, 1), fx, fy, lx, ly, ALPHA, *PARAMS),
        "K5 on the CPU": lambda: tl.la_log_at((32, 1), torch.zeros(2, 5, 4), lx, ly, *PARAMS),
        "too narrow": lambda: tl._geometry_dims((32, 1), 10, 33),
        "not in the library": lambda: tl._geometry_dims((16, 4), 10, 64),
    }
    with pytest.raises(ValueError):
        calls[bad]()


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_exp_plain_version_overflows_where_jax_does(kernel):
    """On the overflow batch the plain version is non-finite exactly on the
    pairs that overflow (3 and 4), as the Pallas function in interpret mode
    is, and finite elsewhere, within 1e-4 of it; the pair with a cell of
    e = 1e38 stays finite."""
    ops, _ = _exp_operands(f"{kernel} overflow")
    if kernel == "K3":
        got = tl.la_exp_factored_reference(*_t(*ops), ALPHA, *PARAMS).numpy()
        want = np.asarray(jp.la_exp_factored(*_j(*ops), ALPHA, *PARAMS, block_b=8,
                                             interpret=True))
    else:
        got = tl.la_exp_reference(*_t(*ops), *PARAMS).numpy()
        want = np.asarray(jp.la_exp_pallas(*_j(*ops), *PARAMS, block_b=8, interpret=True))
    finite = [True, True, True, False, False, True, True, True]
    assert np.isfinite(got).tolist() == finite
    assert np.isfinite(want).tolist() == finite
    assert got[5] > 1e37 and got[7] == 1.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4)


def _exp_launch(case):
    """(wrapper, at, plain value, operands on the card, scalars, kw) of an
    exp-kernel case."""
    ops, s2 = _exp_operands(case)
    ops = [t.cuda() for t in _t(*ops)]
    if case.startswith("K3"):
        wrapper, at, reference = tl.la_exp_factored, tl.la_exp_factored_at, \
            tl.la_exp_factored_reference
        scalars, kw = (ALPHA, *PARAMS), {}
    else:
        wrapper, at, reference = tl.la_exp, tl.la_exp_at, tl.la_exp_reference
        kw = {} if s2 is None else {"scores2": torch.as_tensor(s2).cuda(), "alpha": ALPHA}
        scalars = PARAMS
    want = reference(*ops, *scalars, **kw).cpu().numpy()
    return wrapper, at, want, ops, scalars, kw


def _exp_geometries(ops, case):
    width, kind = ((ops[1].shape[1], "factored") if case.startswith("K3")
                   else (ops[0].shape[2], "scores"))
    return [(0, 0)] + [g for g in tl.EXP_GEOMETRIES[kind] if g[0] * g[1] >= width]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _EXP_CASES)
def test_cuda_exp_kernel_matches_plain_version(case):
    """The exp kernels K3 and K4 on the card against their plain versions at
    the cases of :func:`_exp_operands`, within the 1e-3 rel gate: on the
    route's geometry (one launch, counted, on a lane geometry), on every other
    geometry that holds the width and on the one-warp kernel; and the first 3
    pairs alone equal to their values inside the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    wrapper, at, want, ops, scalars, kw = _exp_launch(case)
    launches, lanes = _calls(wrapper), _calls(wrapper, "lanes")
    got = wrapper(*ops, *scalars, **kw).cpu().numpy()
    assert (_calls(wrapper), _calls(wrapper, "lanes")) == (launches + 1, lanes + 1)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    kw3 = {k: v[:3].contiguous() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    alone = wrapper(*[o[:3].contiguous() for o in ops], *scalars, **kw3).cpu().numpy()
    assert np.array_equal(alone, got[:3])
    for geo in _exp_geometries(ops, case):
        np.testing.assert_allclose(at(geo, *ops, *scalars, **kw).cpu().numpy(), want, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_cuda_exp_kernel_overflows_where_the_plain_version_does(kernel):
    """On the overflow batch every exp geometry is non-finite exactly where
    the plain version is, and within 1e-3 of it elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    wrapper, at, want, ops, scalars, kw = _exp_launch(f"{kernel} overflow")
    finite = np.isfinite(want)
    assert not finite.all()
    for geo in _exp_geometries(ops, kernel):
        got = at(geo, *ops, *scalars, **kw).cpu().numpy()
        assert np.array_equal(np.isfinite(got), finite), geo
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-3)


def test_exp_route_covers_every_width():
    """Every padded shape up to LANE_MAX_LEN rows and columns takes an exp
    lane geometry the library holds and that holds the width; longer or
    wider ones take the one-warp kernel."""
    for factored in (True, False):
        for w in range(1, tl.LANE_MAX_LEN + 1):
            lanes, cols = tl.exp_route(tl.LANE_MAX_LEN, w, factored)
            library = tl.EXP_GEOMETRIES["factored" if factored else "scores"]
            assert (lanes, cols) in library and lanes * cols >= w
        for rows, w in ((1, tl.LANE_MAX_LEN + 1), (1, 1024), (1, tl.MAX_LY),
                        (tl.LANE_MAX_LEN + 1, 120), (5000, 1)):
            assert tl.exp_route(rows, w, factored) == (0, 0)


@pytest.mark.parametrize("bad", ["K3 on the CPU", "K4 on the CPU", "too narrow",
                                 "not in the library"])
def test_exp_lane_geometry_launches_are_checked(bad):
    fx, fy = torch.zeros(2, 5, 6), torch.zeros(2, 4, 6)
    lx = torch.tensor([5, 3], dtype=torch.int32)
    ly = torch.tensor([4, 1], dtype=torch.int32)
    calls = {
        "K3 on the CPU": lambda: tl.la_exp_factored_at((32, 1), fx, fy, lx, ly, ALPHA, *PARAMS),
        "K4 on the CPU": lambda: tl.la_exp_at((32, 1), torch.zeros(2, 5, 4), lx, ly, *PARAMS),
        "too narrow": lambda: tl._geometry_dims((32, 1), 10, 33, log=False),
        "not in the library": lambda: tl._geometry_dims((16, 4), 10, 64, log=False),
    }
    with pytest.raises(ValueError):
        calls[bad]()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_cuda_kernel_takes_ly_1500(kernel):
    """Ly = 1500 on the card: one block a pair, a warp per 1024 columns,
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    ops = [t.cuda() for t in _t(*_long_case(kernel, np.random.default_rng(13)))]
    if kernel == "K2":
        got = tl.la_log_factored(*ops, ALPHA, *PARAMS).cpu().numpy()
        want = tl.la_log_factored_reference(*ops, ALPHA, *PARAMS).cpu().numpy()
        np.testing.assert_allclose(got, want, atol=3e-3)
    else:
        got = tl.la_exp(*ops, *PARAMS).cpu().numpy()
        want = tl.la_exp_reference(*ops, *PARAMS).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3)
