"""The fold DP kernel (csrc/fold_dp.cu) and its wrapper (ops/fold_dp.py).

On the CPU: the interior-loop offset table the wrapper builds is
``_class_kernels`` exactly; the kernel's LUTs are the plain engine's;
CPU tensors take the plain engine and launch nothing; any other device
takes the kernel's wrapper, whose checks raise.  On the card (skipped
without one): the kernel against the plain engine on the same card at the
fold's shapes, within f32 rounding, and bit for bit at the benchmark's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stem_kernel_torch.fold import mccaskill_scaled as ms
from stem_kernel_torch.fold.bpmatrix import alifold_covariance
from stem_kernel_torch.fold.contrafold import contrafold_energy_params, default_weights
from stem_kernel_torch.fold.params import default_params, fast_variant
from stem_kernel_torch.io.profile import Alignment
from stem_kernel_torch.ops import fold_dp
from stem_kernel_torch.utils import tracing

# the kernel against the plain engine on the card.  Up to n of about a
# thousand it gives the plain engine's bits (it sums in torch's orders);
# past that torch splits a sum across blocks and the two differ by f32
# rounding.  BPP 3e-5: the band PERF.md records between a fold padded in a
# batch and the same fold alone on the card (2e-6-3e-5), f32 rounding of
# the same sums in other orders; logZ 1e-5 relative: a few units in its last
# place.
BPP_ATOL, LOGZ_RTOL = 3e-5, 1e-5


def _params(variant):
    if variant == "fast":
        return fast_variant(default_params())
    if variant == "contrafold":
        return contrafold_energy_params(default_weights())
    return default_params()


def _batch(n, lens, seed):
    """Codes (B, n) that fold back on themselves, as tests/test_torch_fold.py
    makes them, and the lengths."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lens), n), np.uint8)
    for i, L in enumerate(lens):
        half = rng.integers(0, 4, L // 2)
        comp = np.array([3, 2, 1, 0])[half[::-1]]
        seq = np.concatenate([half, rng.integers(0, 4, L - 2 * len(half)), comp])
        mut = rng.random(L) < 0.15
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        codes[i, :L] = seq
    return codes, np.asarray(lens, np.int32)


def _alifold_batch(n_aln, width, rows, seed, dummies):
    """(rows (B, R, width), lengths, w_extra, pt_override) of alignments of
    ``rows`` rows, as fold.bpmatrix.alifold_bpps pads them, and ``dummies``
    all-gap alignments of length 0 at the end."""
    rng = np.random.default_rng(seed)
    bsz = n_aln + dummies
    codes = np.full((bsz, rows, width), 4, np.int64)
    w_extra = np.zeros((bsz, width, width), np.float32)
    pt = np.full((bsz, width, width), -1, np.int32)
    lens = np.zeros(bsz, np.int64)
    for b in range(n_aln):
        L = int(rng.integers(width - 20, width + 1))
        base = rng.integers(0, 4, L)
        aln = []
        for _ in range(rows - b % 3):
            s = base.copy()
            mut = rng.random(L) < 0.1
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            aln.append("".join("-" if rng.random() < 0.05 else "ACGU"[x] for x in s))
        _, we, pm, code = alifold_covariance(Alignment(aln))
        codes[b, :code.shape[0], :L] = code
        w_extra[b, :L, :L] = we
        pt[b, :L, :L] = pm
        lens[b] = L
    return codes, lens, w_extra, pt


@pytest.mark.parametrize("variant", ["default", "fast", "contrafold"])
def test_offset_table_is_the_class_kernels(variant):
    params = _params(variant)
    tab = fold_dp.offset_table(params)
    want = [k.astype(np.float32) for k in ms._class_kernels(params)]
    got = [np.zeros((tab.cdim, tab.cdim), np.float32) for _ in want]  # K[t, a] by class
    for w, t, a, c in zip(tab.w, tab.t, tab.a, tab.cls):
        got[c][t, a] = w
    assert len(got) == len(want) == len(ms._cls_names(params)[0])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(tab.w) == sum(int((w != 0).sum()) for w in want)
    key = tab.cls.astype(np.int64) * tab.cdim + tab.a  # by class, then a, then t
    assert (np.diff(key) >= 0).all()
    assert all((np.diff(tab.t[tab.seg[s]: tab.seg[s + 1]]) > 0).all() for s in range(len(tab.seg) - 1))
    assert tab.seg[-1] == len(tab.w) and (tab.t > tab.a).all()
    assert [int((key == s).sum()) for s in range(len(tab.seg) - 1)] == np.diff(tab.seg).tolist()
    assert fold_dp.offset_table(dataclasses.replace(params)) is tab  # built once a parameter set


@pytest.mark.parametrize("variant", ["default", "fast"])
def test_kernel_tables_are_the_plain_engines(variant):
    """One skew for all LUTs gives the values of the plain engine's tables."""
    params = _params(variant)
    codes, lens = _batch(24, (24, 19, 9), 4)
    c, ln, _, _ = ms._inputs(codes, lens, None, None, "cpu")
    logs, exps = ms._span_tables(c, ln, params)
    got = ms._kernel_tables(c, ln, params)
    assert tuple(got) == fold_dp.table_names(params)
    for name, t in got.items():
        want = logs[name] if name in fold_dp.LOG_TABLES else exps[name]
        assert t.is_contiguous() and t.dtype == torch.float32
        assert torch.equal(t, want), name


def test_cpu_tensors_take_the_plain_engine():
    codes, lens = _batch(30, (30, 22, 1, 0), 6)
    before, launched = tracing.counters(), fold_dp.launches()
    got = ms.mccaskill_bpp_batch_scaled(codes, lens, device="cpu")
    assert fold_dp.launches() == launched
    assert tracing.counters().get("fold.batches.kernel", 0) == before.get("fold.batches.kernel", 0)
    want = ms.mccaskill_bpp_batch_scaled_reference(codes, lens, device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_other_devices_take_the_kernel():
    """Off the CPU the fold goes to the kernel's wrapper, never to the plain
    loops: on meta tensors it raises the wrapper's device error."""
    codes, lens = _batch(20, (20, 11), 7)
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        ms.mccaskill_bpp_batch_scaled(codes, lens, device="meta")


def _tables(bsz=2, n=6, params=None):
    params = params or default_params()
    return {k: torch.zeros((bsz, n, n)) for k in fold_dp.table_names(params)}


@pytest.mark.parametrize("edit, match", [
    (None, "runs on cuda, not cpu"),
    (("wpair", torch.zeros((2, 6, 6), dtype=torch.float64)), "float32"),
    (("stack", torch.zeros((2, 6, 7))), "shape"),
    (("mm_i_in", torch.zeros((3, 6, 6))), "shape"),
    (("hairpin", torch.zeros((2, 6, 6)).transpose(1, 2)), "contiguous"),
    (("lengths", torch.zeros(2, dtype=torch.int64)), "int32"),
    (("lengths", torch.zeros(3, dtype=torch.int32)), "shape"),
    (("int22", None), "missing"),
])
def test_wrapper_rejects(edit, match):
    """The wrapper's checks that need no card."""
    tabs, lens = _tables(), torch.zeros(2, dtype=torch.int32)
    if edit is not None:
        name, t = edit
        if name == "lengths":
            lens = t
        elif t is None:
            del tabs[name]
        else:
            tabs[name] = t
    with pytest.raises(ValueError, match=match):
        fold_dp.fold_dp(tabs, lens, default_params())


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


def _ragged(bsz, lo, hi, seed):
    lens = np.random.default_rng(seed).integers(lo, hi + 1, bsz)
    lens[0] = hi
    return _batch(hi, lens, seed)


CARD_CASES = {
    "family200": lambda: (*_ragged(200, 110, 130, 21), "default", {}),
    "batch64": lambda: (*_ragged(64, 100, 128, 22), "default", {}),
    "fast": lambda: (*_ragged(64, 100, 128, 23), "fast", {}),
    "contrafold": lambda: (*_ragged(16, 60, 90, 24), "contrafold", {}),
    "past_ring": lambda: (*_ragged(4, 380, 420, 25), "default", {}),
    "n1000": lambda: (*_batch(1000, (1000,), 26), "default", {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CARD_CASES, "alifold"])
def test_cuda_kernel_matches_plain_engine(case):
    _cuda_or_skip()
    if case == "alifold":
        codes, lens, we, pt = _alifold_batch(14, 64, 8, 27, dummies=2)
        params, kw = default_params(), {"w_extra": we, "pt_override": pt}
    else:
        codes, lens, variant, kw = CARD_CASES[case]()
        params = _params(variant)
    launched = fold_dp.launches()
    batches = tracing.counters().get("fold.batches.kernel", 0)
    got_bpp, got_z = ms.mccaskill_bpp_batch_scaled(codes, lens, params, device="cuda", **kw)
    torch.cuda.synchronize()
    assert fold_dp.launches() == launched + 1
    assert tracing.counters().get("fold.batches.kernel", 0) == batches + 1
    want_bpp, want_z = ms.mccaskill_bpp_batch_scaled_reference(codes, lens, params, device="cuda",
                                                               **kw)
    assert torch.isfinite(got_bpp).all() and torch.isfinite(got_z).all()
    np.testing.assert_allclose(got_z.cpu().numpy(), want_z.cpu().numpy(), rtol=LOGZ_RTOL)
    np.testing.assert_allclose(got_bpp.cpu().numpy(), want_bpp.cpu().numpy(),
                               atol=BPP_ATOL, rtol=0)


BIT_CASES = {
    "family200_n130": lambda: _ragged(200, 110, 130, 31),  # sums split across 8 warps
    "batch64_n128": lambda: _ragged(64, 100, 128, 32),  # across 4 warps
    "batch64_n127": lambda: _ragged(64, 100, 127, 33),  # one warp
    "alone_n130": lambda: _ragged(1, 130, 130, 34),
    "batch200_n122": lambda: _ragged(200, 110, 122, 35),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*BIT_CASES, "fast", "alifold", "rolled"])
def test_cuda_kernel_is_the_plain_engine_bit_for_bit(case):
    """The fold batches of the benchmark's shapes: the kernel's BPP and
    log Z are the plain engine's on the card, bit for bit, which the
    benchmark's references, folded by the plain engine in the program's
    batches, rely on.  A sequence's bits depend on its batch as the plain
    engine's do: rolled by one, the batch gives the rolled engine's bits."""
    _cuda_or_skip()
    params, kw = default_params(), {}
    if case == "fast":
        codes, lens = _ragged(64, 100, 126, 36)
        params = _params("fast")
    elif case == "alifold":
        codes, lens, we, pt = _alifold_batch(14, 64, 8, 37, dummies=2)
        kw = {"w_extra": we, "pt_override": pt}
    elif case == "rolled":
        codes, lens = _ragged(64, 100, 130, 38)
        codes, lens = np.roll(codes, 1, 0), np.roll(lens, 1)
    else:
        codes, lens = BIT_CASES[case]()
    got_bpp, got_z = ms.mccaskill_bpp_batch_scaled(codes, lens, params, device="cuda", **kw)
    want_bpp, want_z = ms.mccaskill_bpp_batch_scaled_reference(codes, lens, params, device="cuda",
                                                               **kw)
    assert torch.equal(got_z, want_z)
    assert torch.equal(got_bpp, want_bpp)
