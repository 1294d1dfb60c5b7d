"""The string-family slice: the port's la_kernel_lite, string_kernel and
simpal CLIs, and the models under them, against the JAX package.

Both CLIs of a pair read the same FASTA files; the port runs with
``--device cpu``.  Bands of the normalized matrices and predict rows (max
abs), with the largest difference measured on these files: la_kernel_lite
5e-7, the JAX CLI's own cross-backend band (1.8e-7); string_kernel 1e-6
(1.2e-7); la_kernel_lite ``--use-bp`` and simpal 1e-4, since both fold
first (1.1e-5 and 2.1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import la_kernel_lite as j_lite
from stem_kernel_tpu.cli import simpal as j_simpal
from stem_kernel_tpu.cli import string_kernel as j_string
from stem_kernel_tpu.fold.bpmatrix import fold_sequences
from stem_kernel_tpu.io.profile import Alignment as JAlignment
from stem_kernel_tpu.models import featurize as j_feat
from stem_kernel_tpu.models import simpal as j_sp
from stem_kernel_tpu.models import string_kernel as j_sk
from stem_kernel_torch.cli import la_kernel_lite as t_lite
from stem_kernel_torch.cli import simpal as t_simpal
from stem_kernel_torch.cli import string_kernel as t_string
from stem_kernel_torch.cli import svm_tools
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.io.profile import Alignment as TAlignment
from stem_kernel_torch.models import featurize as t_feat
from stem_kernel_torch.models import simpal as t_sp
from stem_kernel_torch.models import string_kernel as t_sk
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt
# (CLI, flags, band of the normalized Gram and predict rows)
CASES = {
    "la_kernel_lite": (t_lite.main, j_lite.main, [], 5e-7),
    "la_kernel_lite_use_bp": (t_lite.main, j_lite.main, ["--use-bp"], 1e-4),
    "la_kernel_lite_use_bp_use_alifold": (t_lite.main, j_lite.main,
                                          ["--use-bp", "--use-alifold"], 1e-4),
    "string_kernel": (t_string.main, j_string.main, [], 1e-6),
    "simpal": (t_simpal.main, j_simpal.main, ["-m", "60"], 1e-4),
}


def _seqs(n=4, seed=9):
    rng = np.random.default_rng(seed)

    def mutate(s):
        s = "".join(rng.choice(list("acgu")) if rng.random() < 0.1 else c for c in s)
        cut = int(rng.integers(0, 12))  # lengths 35..59
        return s[cut:] if rng.random() < 0.5 else s + "acgu"[: cut % 5] * 3

    pos = [mutate(CORE) for _ in range(n)]
    return pos, [dinucleotide_shuffle(s, rng) for s in pos]


def _files(tmp_path, n=4):
    pos, neg = _seqs(n)
    paths = {}
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", pos[:2]), ("tneg", neg[:1])):
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


@pytest.mark.parametrize("case", list(CASES))
def test_train_flow_matches_jax_cli(tmp_path, case):
    t_main, j_main, flags, band = CASES[case]
    p = _files(tmp_path)
    grams = {}
    for tag, main, extra in (("t", t_main, ["--device", "cpu"]), ("j", j_main, [])):
        out = str(tmp_path / f"{tag}.dat")
        assert main([*extra, *flags, "-n", out, "+1", p["pos"], "-1", p["neg"]]) == 0
        grams[tag] = read_precomputed(out)
    (t_labels, t_g), (j_labels, j_g) = grams["t"], grams["j"]
    assert t_labels == j_labels == ["+1"] * 4 + ["-1"] * 4
    assert t_g.shape == (8, 8) and np.isfinite(t_g).all()
    np.testing.assert_allclose(np.diag(t_g), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t_g, t_g.T, atol=1e-7)
    assert np.abs(t_g - j_g).max() <= band


@pytest.mark.parametrize("case", list(CASES))
def test_predict_flow_matches_jax_cli(tmp_path, case):
    t_main, j_main, flags, band = CASES[case]
    p = _files(tmp_path)
    km, model = str(tmp_path / "km.dat"), str(tmp_path / "km.model")
    assert t_main(["--device", "cpu", *flags, "-n", km, "+1", p["pos"], "-1", p["neg"]]) == 0
    assert svm_tools.train_main([km, model]) == 0
    outs = {}
    for tag, main, extra in (("t", t_main, ["--device", "cpu"]), ("j", j_main, [])):
        rows, pred, norm = (str(tmp_path / f"{tag}_{f}") for f in ("rows.dat", "pred", "norm"))
        assert main([*extra, *flags, "-n", rows, "--model", model, "--predict", pred,
                     "-x", norm, "--stream-chunk", "2", "+1", p["pos"], "-1", p["neg"],
                     "--test", "+1", p["tpos"], "-1", p["tneg"]]) == 0
        labels, r = read_precomputed(rows)
        decs = [float(line.split()[1]) for line in open(pred).read().splitlines()]
        outs[tag] = (labels, r, np.asarray(decs), np.loadtxt(norm))
    (tl, tr, td, tn), (jl, jr, jd, jn) = outs["t"], outs["j"]
    assert tl == jl == ["+1", "+1", "-1"]
    assert tr.shape == jr.shape == (3, 8) and np.isfinite(tr).all()
    assert np.abs(tr - jr).max() <= band
    # a decision value sums coef * K over <= 8 SVs with |coef| <= C = 1
    np.testing.assert_allclose(td, jd, atol=8 * band)
    np.testing.assert_allclose(tn, jn, rtol=max(band, 1e-6))


def test_featurizers_match_jax():
    pos, neg = _seqs()
    alns = [TAlignment(rows=[s]) for s in pos + neg]
    j_alns = [JAlignment(rows=[s]) for s in pos + neg]
    for key, t, j in (("string", t_feat.string_kernel_features(alns),
                       j_feat.string_kernel_features(j_alns)),
                      ("plain", t_feat.plain_string_features(pos + neg),
                       j_feat.plain_string_features(pos + neg))):
        assert t.keys() == j.keys(), key
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    t_w = t_feat.loop_profile_weights(alns, device="cpu")
    j_w = j_feat.loop_profile_weights(j_alns)
    for a, b in zip(t_w, j_w):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_exact_match_scores_and_plain_kernel_match_jax():
    pos, neg = _seqs()
    f = j_feat.plain_string_features(pos + neg)
    idx = np.random.default_rng(4).integers(0, 8, (2, 12))
    x, y = f["codes"][idx[0]], f["codes"][idx[1]]
    lx, ly = f["length"][idx[0]], f["length"][idx[1]]
    want = np.asarray(j_sk.exact_match_scores(jnp.asarray(x), jnp.asarray(lx), jnp.asarray(y),
                                              jnp.asarray(ly), jnp.float32(0.7)))
    got = t_sk.exact_match_scores(torch.tensor(x), torch.tensor(lx), torch.tensor(y),
                                  torch.tensor(ly), 0.7).numpy()
    np.testing.assert_array_equal(got, want)
    want_k = np.asarray(j_sk.plain_string_kernel(x, lx, y, ly, 0.7))
    got_k = t_sk.plain_string_kernel(torch.tensor(x), torch.tensor(lx), torch.tensor(y),
                                     torch.tensor(ly), 0.7).numpy()
    np.testing.assert_allclose(got_k, want_k, rtol=1e-5)


def test_pal_features_and_simpal_kernels_match_jax():
    pos, neg = _seqs()
    seqs = pos + neg
    bpps = fold_sequences(seqs)
    got = np.stack([t_sp.pal_features(s, b, max_dist=60) for s, b in zip(seqs, bpps)])
    want = np.stack([j_sp.pal_features(s, b, max_dist=60) for s, b in zip(seqs, bpps)])
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    j_g = j_sp.simpal_gram(want, tolerance=1, max_dist=60)
    t_g = t_sp.simpal_gram(got, tolerance=1, max_dist=60, device="cpu")
    np.testing.assert_allclose(t_g, j_g, rtol=1e-5)
    perm = [3, 0, 7, 1, 5, 2, 6, 4]
    vals = t_sp.simpal_kernel_fn(3, 1, 60, device="cpu")(
        {"pal": torch.tensor(got)}, {"pal": torch.tensor(got[perm])}).numpy()
    np.testing.assert_allclose(vals, j_g[np.arange(8), perm], rtol=1e-5)


@pytest.mark.parametrize("cli", ["la_kernel_lite", "string_kernel", "simpal"])
def test_device_cuda_without_gpu_raises(tmp_path, monkeypatch, cli):
    main = {"la_kernel_lite": t_lite.main, "string_kernel": t_string.main,
            "simpal": t_simpal.main}[cli]
    p = _files(tmp_path, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-n", str(tmp_path / "k.dat"), "+1", p["pos"], "-1", p["neg"]])


@pytest.mark.parametrize("cli,flag", [("string_kernel", ["--single-device"]),
                                      ("simpal", ["--devices", "2"])])
def test_unported_options_are_rejected(tmp_path, cli, flag, capsys):
    """In one process, --devices 2 raises, naming the torchrun launch of two
    ranks, and --single-device writes the matrix of the run without it."""
    main = {"la_kernel_lite": t_lite.main, "string_kernel": t_string.main,
            "simpal": t_simpal.main}[cli]
    p = _files(tmp_path, n=1)
    args = ["+1", p["pos"], "-1", p["neg"]]
    out, plain = str(tmp_path / "k.dat"), str(tmp_path / "plain.dat")
    if flag == ["--devices", "2"]:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            main(["--device", "cpu", *flag, "-n", out, *args])
        return
    assert main(["--device", "cpu", *flag, "-n", out, *args]) == 0
    assert main(["--device", "cpu", "-n", plain, *args]) == 0
    assert open(out, "rb").read() == open(plain, "rb").read()
