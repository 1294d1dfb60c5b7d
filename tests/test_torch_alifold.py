"""Port parity: the ALIFOLD path (covariance, averaged LUTs, row batches).

The port's alifold functions against the JAX package's on the same
alignments: ``alifold_covariance`` equal (integer parts exactly),
``alifold_bpp`` within 2e-5 of the JAX function and of the ``ali_*``
goldens (as tests/test_fold_goldens.py holds JAX), the averaged LUTs within
1e-12, the port's batched alifold against its one-at-a-time alifold within
1e-6, and ``bpla_kernel --use-alifold`` against the JAX CLI within the
1.3e-3 band of bpla_kernel.  ``--use-alifold`` changes no value on
``stem_kernel_lite`` and ``la_kernel_lite --use-bp`` in either package:
both fold every row, as the JAX package does.
"""

import os

import numpy as np
import pytest
import torch

from stem_kernel_tpu.fold import bpmatrix as j_bpm
from stem_kernel_tpu.io.profile import Alignment as JAlignment
from stem_kernel_torch.fold import bpmatrix as t_bpm
from stem_kernel_torch.fold.params import default_params
from stem_kernel_torch.fold.tables import build_luts
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.io.profile import Alignment

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "method_bpp.npz")
MDATA = np.load(GOLDEN)
ALI_NAMES = sorted({k.split("__")[0] for k in MDATA.files if k.startswith("ali_")})
ALI_ATOL = 2e-5
BATCH_ATOL = 1e-6
CLI_BAND = 1.3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    made these small folds many times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# two gapped alignments beside the goldens: a minority-row helix and a
# half-gapped family with a compensatory pair
GAPPED = {
    "minority": ["gggaaaaaaccc", "aaaaaaaaaccc", "aaaa-aaaaccc"],
    "gapped_family": ["gggcgcaag-uugaaagcgccc", "ggg-gcaagcuugaaagcg-cc",
                      "gagcgcaagcucgaaagcgcuc", "--gcgcaagcuug-aagcgc--"],
}


def _rows(name):
    if name in GAPPED:
        return GAPPED[name]
    return MDATA[f"{name}__rows"].tobytes().decode().split("\n")


def hairpin_alignments(rng, n_aln, n_rows, length, gap_rate=0.05):
    """A hairpin family as alignments: compensatory and single mutations on
    the stem, 10% loop mutations, about ``gap_rate`` gaps; and per-row
    shuffles of the same alignments (gaps kept in place) as negatives."""
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    k = length // 3
    stem = list(rng.choice(list("acgu"), k))
    loop = list(rng.choice(list("acgu"), length - 2 * k))
    pos = []
    for _ in range(n_aln):
        rows = []
        for _ in range(n_rows):
            s, rc = list(stem), [comp[c] for c in reversed(stem)]
            for i in range(k):
                u = rng.random()
                if u < 0.1:  # compensatory: both bases of the pair
                    b = str(rng.choice(list("acgu")))
                    s[i], rc[k - 1 - i] = b, comp[b]
                elif u < 0.15:  # single mutation
                    s[i] = str(rng.choice(list("acgu")))
            lp = [str(rng.choice(list("acgu"))) if rng.random() < 0.1 else c for c in loop]
            row = s + lp + rc
            row = ["-" if rng.random() < gap_rate else c for c in row]
            rows.append("".join(row))
        pos.append(rows)
    neg = []
    for rows in pos:
        shuffled = []
        for r in rows:
            idx = [i for i, c in enumerate(r) if c != "-"]
            perm = rng.permutation([r[i] for i in idx])
            out = list(r)
            for i, c in zip(idx, perm):
                out[i] = str(c)
            shuffled.append("".join(out))
        neg.append(shuffled)
    return pos, neg


def write_clustal(path, alignments):
    with open(path, "w") as f:
        for a, rows in enumerate(alignments):
            f.write("CLUSTAL W\n\n")
            f.write("".join(f"a{a}_s{r} {row}\n" for r, row in enumerate(rows)))
            f.write("\n")
    return str(path)


@pytest.mark.parametrize("name", ALI_NAMES + sorted(GAPPED))
def test_alifold_covariance_matches_jax(name):
    rows = _rows(name)
    got = t_bpm.alifold_covariance(Alignment(rows=rows))
    want = j_bpm.alifold_covariance(JAlignment(rows=rows))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[0], want[0])  # consensus
    np.testing.assert_array_equal(got[2], want[2])  # majority pair types
    np.testing.assert_array_equal(got[3], want[3])  # row codes
    np.testing.assert_array_equal(got[1], want[1])  # covariance weights


@pytest.mark.parametrize("name", ALI_NAMES + sorted(GAPPED))
def test_alifold_bpp_matches_jax(name):
    rows = _rows(name)
    got = t_bpm.alifold_bpp(Alignment(rows=rows), device="cpu")
    want = j_bpm.alifold_bpp(JAlignment(rows=rows))
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ALI_ATOL)
    if name in ALI_NAMES:
        np.testing.assert_allclose(got, MDATA[f"{name}__bpp"], atol=ALI_ATOL)


def test_averaged_luts_match_jax():
    """Per-row LUTs averaged over rows, with w_extra and the row-aware
    gate, against JAX's _build_luts_averaged (x64) on a gapped alignment."""
    import jax.numpy as jnp

    from stem_kernel_tpu.fold.params import default_params as j_default_params
    from stem_kernel_tpu.fold.tables import build_luts as j_build_luts

    aln = GAPPED["gapped_family"]
    _, we, pt, code = j_bpm.alifold_covariance(JAlignment(rows=aln))
    n = code.shape[1]
    want = j_build_luts(jnp.asarray(code, jnp.int32), jnp.asarray(n), j_default_params(),
                        jnp.asarray(we), pt_override=jnp.asarray(pt))
    got = build_luts(torch.as_tensor(code.astype(np.int64))[None], torch.tensor([n]),
                     default_params(), torch.as_tensor(we)[None],
                     torch.as_tensor(pt.astype(np.int64))[None])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_batched_alifold_equals_one_at_a_time():
    """Alignments of several lengths and depths, folded together (batches
    of one shape a class, dummies filling the last) against each alone."""
    rng = np.random.default_rng(5)
    alns = [Alignment(rows=_rows(nm)) for nm in ALI_NAMES + sorted(GAPPED)]
    pos, neg = hairpin_alignments(rng, 2, 3, 27)
    alns += [Alignment(rows=r) for r in pos + neg]
    batched = t_bpm.bpp_for_alignments(alns, t_bpm.BPMatrixOptions(alifold=True), device="cpu")
    for a, b in zip(alns, batched):
        one = t_bpm.alifold_bpp(a, device="cpu")
        assert b.shape == (a.length, a.length)
        np.testing.assert_allclose(b, one, atol=BATCH_ATOL)
        assert np.array_equal(b, one)  # bit for bit on the CPU


def test_alifold_batch_shape_counts_rows(monkeypatch):
    """One batch shape a (width, depth) class, holding at most
    MAX_BATCH_CELLS cells of B * R * n^2."""
    assert t_bpm._alifold_shape(21, 3) == (64, 4, 24)
    assert t_bpm._alifold_shape(24, 4) == (64, 4, 24)
    assert t_bpm._alifold_shape(121, 8) == (64, 8, 128)
    monkeypatch.setattr(t_bpm, "MAX_BATCH_CELLS", 5 * 8 * 128 * 128)
    assert t_bpm._alifold_shape(121, 8) == (5, 8, 128)
    assert t_bpm._alifold_shape(121, 9) == (3, 12, 128)
    assert t_bpm._alifold_shape(1000, 50) == (1, 52, 1000)


def test_bpla_kernel_use_alifold_matches_jax_cli(tmp_path):
    from stem_kernel_tpu.cli import bpla_kernel as j_bpla
    from stem_kernel_torch.cli import bpla_kernel as t_bpla

    pos, neg = hairpin_alignments(np.random.default_rng(7), 3, 4, 30)
    pf = write_clustal(tmp_path / "pos.aln", pos)
    nf = write_clustal(tmp_path / "neg.aln", neg)
    grams = {}
    for tag, main, extra in (("t", t_bpla.main, ["--device", "cpu"]), ("j", j_bpla.main, [])):
        out = str(tmp_path / f"{tag}.dat")
        assert main([*extra, "--use-alifold", "-n", out, "+1", pf, "-1", nf]) == 0
        grams[tag] = read_precomputed(out)
    (tl, tg), (jl, jg) = grams["t"], grams["j"]
    assert tl == jl == ["+1"] * 3 + ["-1"] * 3
    assert tg.shape == (6, 6) and np.isfinite(tg).all()
    np.testing.assert_allclose(np.diag(tg), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tg, tg.T, atol=1e-7)
    assert np.abs(tg - jg).max() <= CLI_BAND
    # the consensus fold is not the row average: the flag changes the Gram
    out = str(tmp_path / "rows.dat")
    assert t_bpla.main(["--device", "cpu", "-n", out, "+1", pf, "-1", nf]) == 0
    assert np.abs(read_precomputed(out)[1] - tg).max() > 1e-4


@pytest.mark.parametrize("cli", ["stem_kernel_lite", "la_kernel_lite"])
def test_use_alifold_changes_nothing_where_jax_ignores_it(tmp_path, cli):
    """The JAX stem_kernel_lite (models/composite.py fold_sequences) and
    la_kernel_lite --use-bp (models/featurize.py) fold each row and never
    read the alifold option: the flag changes no value, in either package."""
    from stem_kernel_tpu.cli import la_kernel_lite as j_lite
    from stem_kernel_tpu.cli import stem_kernel_lite as j_stem
    from stem_kernel_torch.cli import la_kernel_lite as t_lite
    from stem_kernel_torch.cli import stem_kernel_lite as t_stem

    pos, neg = hairpin_alignments(np.random.default_rng(8), 2, 3, 30)
    pf = write_clustal(tmp_path / "pos.aln", pos)
    nf = write_clustal(tmp_path / "neg.aln", neg)
    mains = {"stem_kernel_lite": (t_stem.main, j_stem.main, ["--precision", "highest"]),
             "la_kernel_lite": (t_lite.main, j_lite.main, ["--use-bp"])}[cli]
    grams = {}
    for tag, main, extra in (("t", mains[0], ["--device", "cpu"]), ("j", mains[1], [])):
        for flag in ([], ["--use-alifold"]):
            out = str(tmp_path / f"{tag}{len(flag)}.dat")
            assert main([*extra, *mains[2], *flag, "-n", out, "+1", pf, "-1", nf]) == 0
            grams[tag, bool(flag)] = read_precomputed(out)[1]
    for tag in ("t", "j"):
        assert np.isfinite(grams[tag, False]).all()
        np.testing.assert_array_equal(grams[tag, True], grams[tag, False])
    band = 1.4e-2 if cli == "stem_kernel_lite" else 1e-4
    assert np.abs(grams["t", True] - grams["j", True]).max() <= band


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_cuda_alifold_matches_cpu_and_batches():
    alns = [Alignment(rows=_rows(nm)) for nm in ALI_NAMES + sorted(GAPPED)]
    opts = t_bpm.BPMatrixOptions(alifold=True)
    card = t_bpm.bpp_for_alignments(alns, opts, device="cuda")
    cpu = t_bpm.bpp_for_alignments(alns, opts, device="cpu")
    for a, g, c in zip(alns, card, cpu):
        np.testing.assert_allclose(g, c, atol=5e-4)
        np.testing.assert_allclose(g, t_bpm.alifold_bpp(a, device="cuda"), atol=BATCH_ATOL)
