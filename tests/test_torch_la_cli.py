"""The BPLA / LA slice as a whole: the port's CLIs against the JAX CLIs.

Both read the same FASTA files.  The port runs with ``--device cpu`` (its
plain torch versions).  Normalized matrices must agree within 1.3e-3 max
abs, the cross-backend band of bpla_kernel.
"""

import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import bpla_kernel as j_bpla
from stem_kernel_tpu.cli import la_kernel as j_la
from stem_kernel_torch.cli import bpla_kernel as t_bpla
from stem_kernel_torch.cli import la_kernel as t_la
from stem_kernel_torch.cli import svm_tools
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

CLI_BAND = 1.3e-3
CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt
AMINO = "ARNDCQEGHILKMFPSTWYV"


def _write(tmp_path, sets):
    paths = {}
    for name, seqs in sets.items():
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


def _rna(tmp_path, n=4, seed=9):
    rng = np.random.default_rng(seed)

    def mutate(s):
        s = "".join(rng.choice(list("acgu")) if rng.random() < 0.1 else c for c in s)
        cut = int(rng.integers(0, 12))  # lengths 35..59
        return s[cut:] if rng.random() < 0.5 else s + "acgu"[: cut % 5] * 3

    pos = [mutate(CORE) for _ in range(n)]
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    return _write(tmp_path, {"pos": pos, "neg": neg, "tpos": pos[:2], "tneg": neg[:1]})


def _proteins(tmp_path, n=4, seed=3):
    """A mutated 40-residue family (lengths 30..50) against residue shuffles."""
    rng = np.random.default_rng(seed)
    core = rng.choice(list(AMINO), size=40)
    pos = []
    for _ in range(n):
        s = [rng.choice(list(AMINO)) if rng.random() < 0.1 else c for c in core]
        cut = int(rng.integers(-10, 11))
        pos.append("".join(s[:cut] if cut < 0 else s + list(rng.choice(list(AMINO), cut))))
    neg = ["".join(rng.permutation(list(s))) for s in pos]
    return _write(tmp_path, {"pos": pos, "neg": neg})


def _gram(main, extra, out, p):
    assert main([*extra, "-n", out, "+1", p["pos"], "-1", p["neg"]]) == 0
    return read_precomputed(out)


BPLA_FLAGS = {
    "default": [], "noBP": ["--noBP"], "SW": ["--SW"],
    "use_alifold": ["--use-alifold"], "use_contrafold": ["--use-contrafold", "default"],
    "a_b_g_e": ["-a", "3.5", "-b", "0.2", "-g", "-6", "-e", "-0.5"],
    "score": ["--score", "SCORE"],
    "SW_score": ["--SW", "--score", "SCORE"],
}


@pytest.mark.parametrize("flags", list(BPLA_FLAGS.values()), ids=list(BPLA_FLAGS))
def test_bpla_train_flow_matches_jax_cli(tmp_path, flags):
    p = _rna(tmp_path)
    if "SCORE" in flags:
        score = tmp_path / "score.txt"
        score.write_text("a u 1.5\nc g 2.5\ng u 0.5\na a -0.5\n")
        flags = [str(score) if f == "SCORE" else f for f in flags]
    t_labels, t_g = _gram(t_bpla.main, ["--device", "cpu", *flags], str(tmp_path / "t.dat"), p)
    j_labels, j_g = _gram(j_bpla.main, flags, str(tmp_path / "j.dat"), p)
    assert t_labels == j_labels == ["+1"] * 4 + ["-1"] * 4
    assert t_g.shape == (8, 8) and np.isfinite(t_g).all()
    np.testing.assert_allclose(np.diag(t_g), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t_g, t_g.T, atol=1e-7)
    assert np.abs(t_g - j_g).max() <= CLI_BAND


def test_bpla_predict_flow_matches_jax_cli(tmp_path):
    p = _rna(tmp_path)
    km, model = str(tmp_path / "km.dat"), str(tmp_path / "km.model")
    _gram(t_bpla.main, ["--device", "cpu"], km, p)
    assert svm_tools.train_main([km, model]) == 0
    outs = {}
    for tag, main, extra in (("t", t_bpla.main, ["--device", "cpu"]), ("j", j_bpla.main, [])):
        rows, pred, norm = (str(tmp_path / f"{tag}_{f}") for f in ("rows.dat", "pred", "norm"))
        assert main([*extra, "-n", rows, "--model", model, "--predict", pred, "-x", norm,
                     "--stream-chunk", "2", "+1", p["pos"], "-1", p["neg"],
                     "--test", "+1", p["tpos"], "-1", p["tneg"]]) == 0
        labels, r = read_precomputed(rows)
        decs = [float(line.split()[1]) for line in open(pred).read().splitlines()]
        outs[tag] = (labels, r, np.asarray(decs), np.loadtxt(norm))
    (tl_, tr, td, tn), (jl, jr, jd, jn) = outs["t"], outs["j"]
    assert tl_ == jl == ["+1", "+1", "-1"]
    assert tr.shape == jr.shape == (3, 8) and np.isfinite(tr).all()
    assert np.abs(tr - jr).max() <= CLI_BAND
    # a decision value sums coef * K over <= 8 SVs with |coef| <= C = 1
    np.testing.assert_allclose(td, jd, atol=8 * CLI_BAND)
    # the norm file holds exp(log K(t, t)), far past 1e30 here
    np.testing.assert_allclose(tn, jn, rtol=1e-3)


@pytest.mark.parametrize("flags", [[], ["--SW"], ["-g", "-9", "-e", "-0.8", "-b", "0.2"],
                                   ["--SW", "-g", "-9", "-e", "-0.8"]],
                         ids=["LA", "SW", "g_e_b", "SW_g_e"])
def test_la_kernel_matches_jax_cli(tmp_path, flags):
    p = _proteins(tmp_path)
    t_labels, t_g = _gram(t_la.main, ["--device", "cpu", *flags], str(tmp_path / "t.dat"), p)
    j_labels, j_g = _gram(j_la.main, flags, str(tmp_path / "j.dat"), p)
    assert t_labels == j_labels == ["+1"] * 4 + ["-1"] * 4
    assert t_g.shape == (8, 8) and np.isfinite(t_g).all()
    np.testing.assert_allclose(np.diag(t_g), 1.0, rtol=1e-5)
    assert np.abs(t_g - j_g).max() <= CLI_BAND


@pytest.mark.parametrize("cli", ["bpla_kernel", "la_kernel"])
def test_device_cuda_without_gpu_raises(tmp_path, monkeypatch, cli):
    p = _proteins(tmp_path, n=1) if cli == "la_kernel" else _rna(tmp_path, n=1)
    main = t_la.main if cli == "la_kernel" else t_bpla.main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda", "-n", str(tmp_path / "k.dat"), "+1", p["pos"], "-1", p["neg"]])


@pytest.mark.parametrize("cli,flag", [("bpla_kernel", ["--single-device"]),
                                      ("la_kernel", ["--devices", "2"])])
def test_unported_options_are_rejected(tmp_path, cli, flag, capsys):
    """In one process, --devices 2 raises, naming the torchrun launch of two
    ranks, and --single-device writes the matrix of the run without it."""
    p = _proteins(tmp_path, n=1) if cli == "la_kernel" else _rna(tmp_path, n=1)
    main = t_la.main if cli == "la_kernel" else t_bpla.main
    out, plain = str(tmp_path / "k.dat"), str(tmp_path / "plain.dat")
    if flag == ["--devices", "2"]:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            main(["--device", "cpu", *flag, "-n", out, "+1", p["pos"], "-1", p["neg"]])
        return
    _gram(main, ["--device", "cpu", *flag], out, p)
    _gram(main, ["--device", "cpu"], plain, p)
    assert open(out, "rb").read() == open(plain, "rb").read()
