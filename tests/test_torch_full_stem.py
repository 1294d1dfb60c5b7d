"""Port parity: the pair HMM and the full stem kernel against the JAX package.

The same numpy inputs, made from seeds, go through the JAX package (the
reference; its Pallas kernel in interpret mode, as tests/test_full_stem.py
runs it) and the PyTorch port, which runs its plain torch versions here (CPU
tensors).  Bounds: 1e-5 on the log-space recurrences and PHMM tables (plus a
few f32 ulps of the larger log values), equality where the output is an
integer window or anchor, rtol 1e-5 for the dense kernel, and for the banded
log kernel the bounds tests/test_full_stem.py holds the Pallas kernel to
(2e-5 against the XLA scan, 5e-5 in its fuzz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from full_stem_oracle import full_stem_ref
from stem_kernel_tpu.io.alphabet import encode as j_encode
from stem_kernel_tpu.models import full_stem as jf
from stem_kernel_tpu.models import phmm as jp
from stem_kernel_tpu.models import ribosum_data as j_rib
from stem_kernel_tpu.ops import recurrence as jr
from stem_kernel_tpu.ops.pallas_full_stem import full_stem_banded_pallas_log
from stem_kernel_torch.io.alphabet import encode
from stem_kernel_torch.models import full_stem as tf
from stem_kernel_torch.models import phmm as tp
from stem_kernel_torch.models import ribosum_data as t_rib
from stem_kernel_torch.ops import full_stem_banded as tk
from stem_kernel_torch.ops import recurrence as tr
from stem_kernel_torch.utils.tracing import counters

WEIGHTS = (0.8, 1.0, 0.5)  # gap, stack, subst (the stem_kernel CLI defaults)
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def _hairpins(rng, b, n, lo, hi, mutate=0.15):
    """(codes (b, n) uint8, lengths int32, pair weights (b, n, n) f32):
    stem / loop / reverse-complement cores with point mutations."""
    codes = np.zeros((b, n), np.uint8)
    bp = np.zeros((b, n, n), np.float32)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        ln = int(rng.integers(lo, hi + 1))
        stem = rng.integers(0, 4, ln // 3)
        rc = np.array([COMP[int(c)] for c in stem[::-1]])
        c = np.concatenate([stem, rng.integers(0, 4, ln - 2 * len(stem)), rc]).astype(np.uint8)
        hit = rng.random(ln) < mutate
        c[hit] = rng.integers(0, 4, int(hit.sum()))
        codes[i, :ln] = c
        lens[i] = ln
        bp[i, :ln, :ln] = tf.pair_weights(c, ln)
    return codes, lens, bp


def _pack(pairs):
    """Sequence pairs padded to one width: x, y codes, lengths, weights."""
    n = max(len(s) for pair in pairs for s in pair) + 1
    out = [np.zeros((len(pairs), n), np.uint8), np.zeros((len(pairs), n), np.uint8),
           np.zeros(len(pairs), np.int32), np.zeros(len(pairs), np.int32),
           np.zeros((len(pairs), n, n), np.float32), np.zeros((len(pairs), n, n), np.float32)]
    for i, (a, b) in enumerate(pairs):
        for side, s in enumerate((a, b)):
            c = encode(s)
            out[side][i, : len(c)] = c
            out[2 + side][i] = len(c)
            out[4 + side][i, : len(c), : len(c)] = tf.pair_weights(c, len(c))
    return out


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ recurrence


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_recurrence_repair_matches_jax_at_phmm_weight(reverse):
    """The PHMM's in-row IY chain: weight -15 along a 300-column row.  The
    closed form a*t + logcumsumexp(b - a*t) was off by 4.3e-4 here."""
    rng = np.random.default_rng(20)
    b = rng.normal(-5.0, 3.0, size=(4, 300)).astype(np.float32)
    b[1, 40:90] = tp.NEG
    want = np.asarray(jr.logsumexp_recurrence(-15.0, jnp.asarray(b), reverse=reverse))
    got = tr.logsumexp_recurrence(-15.0, torch.as_tensor(b), reverse=reverse).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_constants_equal_jax():
    assert tp.TRANS.dtype == jp.TRANS.dtype and np.array_equal(tp.TRANS, jp.TRANS)
    assert (tp.M, tp.IX, tp.IY, tp.NEG) == (jp.M, jp.IX, jp.IY, jp.NEG)
    assert t_rib.RIBOSUM_S.dtype == j_rib.RIBOSUM_S.dtype
    assert np.array_equal(t_rib.RIBOSUM_S, j_rib.RIBOSUM_S)


# ------------------------------------------------------------------ PHMM


def test_phmm_forward_backward_match_jax():
    rng = np.random.default_rng(21)
    x, lx, _ = _hairpins(rng, 4, 30, 10, 29)
    y, ly, _ = _hairpins(rng, 4, 26, 10, 25)
    x[2, 5] = 15  # an N: the emission gather clamps it, as JAX does
    fw_j, z_j = jp.phmm_forward(*_j(x, lx, y, ly))
    fw_t, z_t = tp.phmm_forward(*_t(x, lx, y, ly))
    bk_j = np.asarray(jp.phmm_backward(*_j(x, lx, y, ly)))
    bk_t = tp.phmm_backward(*_t(x, lx, y, ly)).numpy()
    for got, want in ((fw_t.numpy(), np.asarray(fw_j)), (bk_t, bk_j)):
        assert got.shape == want.shape == (3, 4, 31, 27)
        finite = want > -1e29
        assert np.array_equal(got > -1e29, finite)
        # |log values| reach ~400, where one f32 ulp is 3e-5
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6, atol=1e-5)
    fb, logz = tp.phmm_posterior(*_t(x, lx, y, ly))
    fb_j, logz_j = jp.phmm_posterior(*_j(x, lx, y, ly))
    np.testing.assert_allclose(fb, fb_j, atol=1e-5)
    c_t = tp.alignment_constraints(fb[:, 0], int(lx[0]), int(ly[0]), 0.5, band=3)
    c_j = jp.alignment_constraints(fb_j[:, 0], int(lx[0]), int(ly[0]), 0.5, band=3)
    assert all(np.array_equal(a, b) for a, b in zip(c_t, c_j))


@pytest.mark.parametrize("bound,band", [(0.5, 0), (0.3, 3), (0.9, 6), (2.0, 0)])
def test_posterior_windows_equal_jax(bound, band):
    rng = np.random.default_rng(22)
    x, lx, _ = _hairpins(rng, 5, 28, 8, 27)
    y, ly, _ = _hairpins(rng, 5, 28, 8, 27)
    y[:2] = x[:2]  # similar pairs: informative windows
    ly[:2] = lx[:2]
    want = jp.posterior_windows(*_j(x, lx, y, ly), bound, band)
    got = tp.posterior_windows(*_t(x, lx, y, ly), bound, band)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_phmm_anchor_equal_jax():
    pairs = [("gggcgcaagcuugaaagcgccc", "gggcgcaagcuugaaagcgccc"),
             ("gggcgcaagcuugaaagcgccc", "gggcgaagcuugaaagcccc"),  # internal deletions
             ("gggcgcaagcuugaaagcgcccaugcuuaacgcaaagcguua", "gggcgcaagcuugaaagcgcccuua")]
    x, y, lx, ly, _, _ = _pack(pairs)
    for bound in (0.3, 0.5):
        want = jf.phmm_anchor(*_j(x, lx, y, ly), bound)
        got = tf.phmm_anchor(*_t(x, lx, y, ly), bound)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------- pair weights


@pytest.mark.parametrize("variant", ["wobble", "noGU", "loop 5", "bpp"])
def test_pair_weights_equal_jax(variant):
    rng = np.random.default_rng(23)
    seq = "".join(rng.choice(list("acgu"), 24))
    c = encode(seq)
    assert np.array_equal(c, j_encode(seq))
    kw = {"wobble": {}, "noGU": {"use_GU": False}, "loop 5": {"min_loop": 5},
          "bpp": {"bpp": rng.uniform(0, 0.2, (24, 24)), "bp_bound": 0.05}}[variant]
    got = tf.pair_weights(c, 20, **kw)
    want = jf.pair_weights(c, 20, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ dense kernel


@pytest.mark.parametrize("variant", ["free", "band 3", "windows", "full windows"])
def test_dense_kernel_matches_jax_and_oracle(variant):
    pairs = [("gggaaaccc", "ggcaaagcc"), ("gcgcaaagcgcau", "gggaaaccc"),
             ("acguacguagg", "ugcaugca"), ("ggcaaagccaugc", "gggcaaagcccaugg")]
    x, y, lx, ly, bx, by = _pack(pairs)
    kw_j, kw_t = {}, {}
    if variant == "band 3":
        kw_j = kw_t = {"band": 3}
    elif variant.endswith("windows"):
        n = x.shape[1]
        if variant == "windows":
            lo, hi = jp.posterior_windows(*_j(x, lx, y, ly), 0.3, 2)
            lo, hi = np.array(lo), np.array(hi)
        else:
            lo = np.zeros((4, n + 1), np.int32)
            hi = np.broadcast_to(ly[:, None], (4, n + 1)).astype(np.int32)
        kw_j = {"win_lo": jnp.asarray(lo), "win_hi": jnp.asarray(hi)}
        kw_t = {"win_lo": torch.as_tensor(lo), "win_hi": torch.as_tensor(hi)}
    want = np.asarray(jf.full_stem_kernel(*_j(x, y, lx, ly, bx, by), *WEIGHTS, **kw_j))
    got = tf.full_stem_kernel(*_t(x, y, lx, ly, bx, by), *WEIGHTS, **kw_t).numpy()
    assert np.isfinite(got).all() and (got >= 1.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if variant in ("free", "full windows"):
        for i, (a, b) in enumerate(pairs):
            ca, cb = encode(a), encode(b)
            ref = full_stem_ref(ca, cb, tf.pair_weights(ca, len(a)), tf.pair_weights(cb, len(b)),
                                *WEIGHTS)
            np.testing.assert_allclose(got[i], ref, rtol=1e-4)


# ----------------------------------------------------------- banded kernel

BANDED_CASES = {
    "lx == ly": ([("gggaaacccaugcaaggcauuca", "ggcaaagccgcaaagcggauacc")], 4, 0.0),
    "lx != ly": ([("gggaaacccaugcaagg", "gggaaaccc"), ("gcgcaaagcgcaugc", "ggcaaagcc")], 6, 0.0),
    "swapped": ([("gggaaaccc", "gggaaacccaugcaagg"), ("ggcaaagcc", "gcgcaaagcgcaugc")], 4, 0.0),
    "ali 0.3 indel": ([("gggcgcaagcuugaaagcgcccaugcuuaacgcaaagcguua",
                        "gggcgcaagcuugaaagcgcccuua")], 4, 0.3),
    "ali 0.5 similar": ([("gggaaacccaugcaaggcauuca", "gggaaacccaugcaagguauuca")], 5, 0.5),
}


@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_banded_plain_matches_jax_scan_and_pallas(case):
    pairs, band, ali = BANDED_CASES[case]
    ops = _pack(pairs)
    got = tf.full_stem_kernel_banded_log(*_t(*ops), *WEIGHTS, band=band, ali_bound=ali).numpy()
    want = np.asarray(jf.full_stem_kernel_banded_log(*_j(*ops), *WEIGHTS, band=band,
                                                      ali_bound=ali))
    pallas = np.asarray(full_stem_banded_pallas_log(*_j(*ops), *WEIGHTS, band=band,
                                                    ali_bound=ali, interpret=True))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5)
    if case == "swapped":  # a pair and its swap: bit-identical
        x, y, lx, ly, bx, by = ops
        back = tf.full_stem_kernel_banded_log(*_t(y, x, ly, lx, by, bx), *WEIGHTS, band=band)
        assert np.array_equal(back.numpy(), got)


def test_banded_mismatched_pads_and_batch():
    """Predict chunks come at their own pad width; ragged batch with lx = 0,
    random hairpins, against the XLA scan and the Pallas kernel (interpret)."""
    rng = np.random.default_rng(24)
    x, lx, bx = _hairpins(rng, 6, 34, 8, 33)
    y, ly, by = _hairpins(rng, 6, 22, 8, 21)
    lx[5] = 0
    bx[5] = 0.0
    ops = (x, y, lx, ly, bx, by)
    got = tk.full_stem_banded_log(*_t(*ops), *WEIGHTS, band=5).numpy()
    want = np.asarray(jf.full_stem_kernel_banded_log(*_j(*ops), *WEIGHTS, band=5))
    pallas = np.asarray(full_stem_banded_pallas_log(*_j(*ops), *WEIGHTS, band=5, interpret=True))
    assert got[5] == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=5e-5)


def test_banded_equals_dense_band_at_equal_lengths():
    """lx == ly: the windows are exact inside the band, so the banded kernel
    equals the dense kernel with the same band."""
    ops = _pack([("gggaaacccaugcaaggcauuca", "ggcaaagccgcaaagcggauacc")])
    dense = tf.full_stem_kernel(*_t(*ops), *WEIGHTS, band=4).numpy()
    banded = tf.full_stem_kernel_banded(*_t(*ops), *WEIGHTS, band=4)
    np.testing.assert_allclose(banded, dense, rtol=2e-5)


@pytest.mark.parametrize("engine", ["banded", "banded ali", "dense"])
def test_batch_invariance(engine):
    """3 pairs alone and inside a batch of 16: bit-identical values."""
    rng = np.random.default_rng(25)
    x, lx, bx = _hairpins(rng, 16, 24, 8, 23)
    y, ly, by = _hairpins(rng, 16, 24, 8, 23)
    ops = (x, y, lx, ly, bx, by)
    if engine == "dense":
        fn = lambda *a: tf.full_stem_kernel(*a, *WEIGHTS, band=3)  # noqa: E731
    else:
        ali = 0.3 if engine == "banded ali" else 0.0
        fn = lambda *a: tk.full_stem_banded_log(*a, *WEIGHTS, band=4, ali_bound=ali)  # noqa: E731
    full = fn(*_t(*ops)).numpy()
    alone = fn(*_t(*(o[:3] for o in ops))).numpy()
    assert np.isfinite(full).all()
    assert np.array_equal(alone, full[:3])


# --------------------------------------------------------------- wrapper


def test_wrapper_takes_the_plain_version_on_cpu():
    ops = _t(*_pack([("gggaaacccaugcaagg", "gggaaaccc")]))
    before = counters().get("k6.calls", 0)
    got = tk.full_stem_banded_log(*ops, *WEIGHTS, band=4)
    want = tk.full_stem_banded_log_reference(*ops, *WEIGHTS, band=4)
    assert np.array_equal(got.numpy(), want.numpy())
    assert counters().get("k6.calls", 0) == before  # no kernel on the CPU


def test_band_40_matches_jax_scan():
    """A band the CUDA kernel took only up to 32 before: the wrapper takes
    any band on the CPU; against the XLA scan, lx != ly, 60-90 nt."""
    rng = np.random.default_rng(30)
    x, lx, bx = _hairpins(rng, 3, 91, 60, 90)
    y, ly, by = _hairpins(rng, 3, 91, 60, 90)
    ops = (x, y, lx, ly, bx, by)
    got = tk.full_stem_banded_log(*_t(*ops), *WEIGHTS, band=40).numpy()
    want = np.asarray(jf.full_stem_kernel_banded_log(*_j(*ops), *WEIGHTS, band=40))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("bad", ["band 0", "band -1", "band float", "int64 lengths",
                                 "int64 y lengths", "lengths shape", "float64 weights",
                                 "float16 x weights", "int codes", "float y codes", "1-D codes",
                                 "1-D y codes", "strided weights", "strided y weights",
                                 "weights shape"])
def test_wrapper_rejects_bad_operands(bad):
    x, y, lx, ly, bx, by = _t(*_pack([("gggaaacccaugc", "gggaaaccc")]))
    args = {"x": x, "y": y, "lx": lx, "ly": ly, "bx": bx, "by": by}
    band = {"band 0": 0, "band -1": -1, "band float": 4.0}.get(bad, 4)
    if bad == "int64 lengths":
        args["lx"] = lx.long()
    elif bad == "int64 y lengths":
        args["ly"] = ly.long()
    elif bad == "lengths shape":
        args["lx"] = torch.cat([lx, lx])
    elif bad == "float64 weights":
        args["by"] = by.double()
    elif bad == "float16 x weights":
        args["bx"] = bx.half()
    elif bad == "int codes":
        args["x"] = x.int()
    elif bad == "float y codes":
        args["y"] = y.float()
    elif bad == "1-D codes":
        args["x"] = x[0]
    elif bad == "1-D y codes":
        args["y"] = y[0]
    elif bad == "strided weights":
        args["bx"] = bx.transpose(1, 2)
    elif bad == "strided y weights":
        args["by"] = by.transpose(1, 2)
    elif bad == "weights shape":
        args["by"] = by[:, :-1, :-1]
    with pytest.raises(ValueError):
        tk.full_stem_banded_log(*args.values(), *WEIGHTS, band=band)


def test_precision_other_than_highest_is_rejected():
    ops = _t(*_pack([("gggaaaccc", "gggaaaccc")]))
    with pytest.raises(ValueError, match="highest"):
        tf.full_stem_kernel_banded_log(*ops, *WEIGHTS, band=3, precision="default")


@pytest.mark.cuda
def test_cuda_scale_division_is_ieee():
    """The kernel divides by a level's scale without __fdiv_rn's branch: the
    quotient is the IEEE f32 one (the f64 quotient of two f32 values, rounded
    to f32) bit for bit wherever it is a normal f32, and within one unit in
    the last place where it is subnormal; dividends span 2^-149..2^20."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(28)
    x = (2.0 ** rng.uniform(-149, 20, 1 << 20)).astype(np.float32)
    x[rng.random(x.size) < 0.05] = 0.0
    xt = torch.as_tensor(x, device="cuda")
    for m in (1e-30, 1e-6, 0.37, 1.0, 3.0, 1234.5, 1e12):
        m = np.float32(m)
        want = (x.astype(np.float64) / np.float64(m)).astype(np.float32)
        got = tk._div_scale(xt, float(m)).cpu().numpy()
        normal = np.abs(want) >= np.float32(2.0 ** -126)
        assert np.array_equal(got[normal].view(np.int32), want[normal].view(np.int32))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["square", "lx != ly", "ali 0.5"])
def test_cuda_kernel_matches_plain_version(case):
    """K6 against its plain version on the card: ragged lengths, swapped
    and mismatched pads, PHMM anchors; a pair's value alone equal to its
    value inside the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(26)
    x, lx, bx = _hairpins(rng, 9, 61, 20, 60)
    y, ly, by = (x, lx, bx) if case == "square" else _hairpins(rng, 9, 45, 20, 44)
    ali = 0.5 if case == "ali 0.5" else 0.0
    ops = [t.cuda() for t in _t(x, y, lx, ly, bx, by)]
    launches = counters().get("k6.calls", 0)
    got = tk.full_stem_banded_log(*ops, *WEIGHTS, band=8, ali_bound=ali).cpu().numpy()
    torch.cuda.synchronize()
    assert counters().get("k6.calls", 0) == launches + 1
    want = tk.full_stem_banded_log_reference(*ops, *WEIGHTS, band=8, ali_bound=ali)
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=0, atol=1e-3)
    first3 = [o[:3].contiguous() for o in ops]
    alone = tk.full_stem_banded_log(*first3, *WEIGHTS, band=8, ali_bound=ali).cpu().numpy()
    assert np.array_equal(alone, got[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [40, 70])
def test_cuda_kernel_wide_band_matches_plain_version(band):
    """K6 above band 32 on the card: two opted-in shared-memory planes, and
    above band 63 a scan thread takes two lines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(31)
    x, lx, bx = _hairpins(rng, 4, 91, 60, 90)
    y, ly, by = _hairpins(rng, 4, 91, 60, 90)
    ops = [t.cuda() for t in _t(x, y, lx, ly, bx, by)]
    got = tk.full_stem_banded_log(*ops, *WEIGHTS, band=band).cpu().numpy()
    torch.cuda.synchronize()
    want = tk.full_stem_banded_log_reference(*ops, *WEIGHTS, band=band)
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=0, atol=1e-3)
