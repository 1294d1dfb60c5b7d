"""The full stem slice as a whole: the port's stem_kernel CLI against the JAX CLI.

Both read the same FASTA files; the port runs with ``--device cpu`` (its
plain torch versions).  The matrices agree within 1e-4 max abs on every
route (banded, banded with PHMM anchors, dense, dense with PHMM windows,
and the predict flow with a test pad wider than the training pad); with
``-p`` the folded pair weights carry the fold's f32 differences, so that
route is held to the 1.4e-2 band of the folded CLIs.
"""

import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import stem_kernel as j_cli
from stem_kernel_torch.cli import stem_kernel as t_cli
from stem_kernel_torch.cli import svm_tools
from stem_kernel_torch.gram.io import read_precomputed

BAND = 1e-4
FOLD_BAND = 1.4e-2
TRAIN = {"pos": ["gggcgcaagcuugaaagcgccc", "gggcgcaagucugaaagcgccc", "gggcgcaagcuugaagcgcccaug"],
         "neg": ["ggacgcaagcuuga", "cggcgcaaguuugaaagcgccg", "auagcuaggcuagcuuaacgg"]}
TEST = {"tpos": ["gggcgcaagcuugaaagcgcccaugcaaagg"],  # longer than any training sequence
        "tneg": ["cgaucgauuagcga"]}


def _files(tmp_path, sets):
    paths = {}
    for name, seqs in sets.items():
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


def _train(main, extra, out, p):
    assert main([*extra, "-n", out, "+1", p["pos"], "-1", p["neg"]]) == 0
    return read_precomputed(out)


@pytest.mark.parametrize("flags,band", [(["-b", "6"], BAND), (["-b", "6", "-a", "0.5"], BAND),
                                        ([], BAND), (["-a", "0.5"], BAND),
                                        (["-b", "6", "-p", "0.01"], FOLD_BAND),
                                        (["-b", "6", "-l", "4", "-s", "1.5", "-v", "0.3",
                                          "-g", "0.6"], BAND)],
                         ids=["banded", "banded PHMM anchors", "dense", "dense PHMM windows",
                              "banded folded weights", "banded_l_s_v_g"])
def test_train_flow_matches_jax_cli(tmp_path, flags, band):
    p = _files(tmp_path, TRAIN)
    t_labels, t_g = _train(t_cli.main, ["--device", "cpu", *flags], str(tmp_path / "t.dat"), p)
    j_labels, j_g = _train(j_cli.main, ["--single-device", *flags], str(tmp_path / "j.dat"), p)
    assert t_labels == j_labels == ["+1"] * 3 + ["-1"] * 3
    assert t_g.shape == (6, 6) and np.isfinite(t_g).all()
    np.testing.assert_allclose(np.diag(t_g), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t_g, t_g.T, atol=1e-7)
    assert np.abs(t_g - j_g).max() <= band


def _mixed(rng, n, lo, hi):
    """Stem / loop / reverse-complement sequences of lo..hi nt."""
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        stem = "".join(rng.choice(list("acgu"), size=ln // 3))
        mid = "".join(rng.choice(list("acgu"), size=ln - 2 * len(stem)))
        out.append(stem + mid + "".join(comp[c] for c in reversed(stem)))
    return out


def test_band_40_matches_jax_cli(tmp_path):
    """-b 40, above the CUDA kernel's former limit of 32, on 60-90 nt."""
    seqs = _mixed(np.random.default_rng(5), 3, 60, 80)
    p = _files(tmp_path, {"pos": seqs[:2], "neg": seqs[2:]})
    t_labels, t_g = _train(t_cli.main, ["--device", "cpu", "-b", "40"], str(tmp_path / "t.dat"), p)
    j_labels, j_g = _train(j_cli.main, ["--single-device", "-b", "40"], str(tmp_path / "j.dat"), p)
    assert t_labels == j_labels == ["+1"] * 2 + ["-1"]
    assert np.isfinite(t_g).all()
    assert np.abs(t_g - j_g).max() <= BAND


@pytest.mark.parametrize("flags", [["-b", "5"], []], ids=["banded", "dense"])
def test_predict_flow_matches_jax_cli(tmp_path, flags):
    p = _files(tmp_path, {**TRAIN, **TEST})
    km, model = str(tmp_path / "km.dat"), str(tmp_path / "km.model")
    _train(t_cli.main, ["--device", "cpu", *flags], km, p)
    assert svm_tools.train_main([km, model]) == 0
    outs = {}
    for tag, main, extra in (("t", t_cli.main, ["--device", "cpu"]),
                             ("j", j_cli.main, ["--single-device"])):
        rows, pred, norm = (str(tmp_path / f"{tag}_{f}") for f in ("rows.dat", "pred", "norm"))
        assert main([*extra, *flags, "-n", rows, "--model", model, "--predict", pred,
                     "-x", norm, "+1", p["pos"], "-1", p["neg"],
                     "--test", "+1", p["tpos"], "-1", p["tneg"]]) == 0
        labels, r = read_precomputed(rows)
        decs = [float(line.split()[1]) for line in open(pred).read().splitlines()]
        outs[tag] = (labels, r, np.asarray(decs), np.loadtxt(norm))
    (tl, tr, td, tn), (jl, jr, jd, jn) = outs["t"], outs["j"]
    assert tl == jl == ["+1", "-1"]
    assert tr.shape == jr.shape == (2, 6) and np.isfinite(tr).all()
    assert np.abs(tr - jr).max() <= BAND
    # a decision value sums coef * K over <= 6 SVs with |coef| <= C = 1
    np.testing.assert_allclose(td, jd, atol=6 * BAND)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


def test_device_cuda_without_gpu_raises(tmp_path, monkeypatch):
    p = _files(tmp_path, TRAIN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--device", "cuda", "-n", "-b", "6", str(tmp_path / "k.dat"),
                    "+1", p["pos"], "-1", p["neg"]])


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--single-device"]])
def test_unported_options_are_rejected(tmp_path, flag, capsys):
    """In one process, --devices 2 raises, naming the torchrun launch of two
    ranks, and --single-device writes the matrix of the run without it."""
    p = _files(tmp_path, TRAIN)
    args = ["--device", "cpu", "-b", "6"]
    out, plain = str(tmp_path / "k.dat"), str(tmp_path / "plain.dat")
    if flag == ["--devices", "2"]:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            _train(t_cli.main, [*args, *flag], out, p)
        return
    _train(t_cli.main, [*args, *flag], out, p)
    _train(t_cli.main, args, plain, p)
    assert open(out, "rb").read() == open(plain, "rb").read()


@pytest.mark.cuda
def test_band_40_cuda_matches_cpu(tmp_path):
    """-b 40 on the card (K6 with opted-in shared memory) against --device cpu."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    seqs = _mixed(np.random.default_rng(5), 3, 60, 80)
    p = _files(tmp_path, {"pos": seqs[:2], "neg": seqs[2:]})
    _, c_g = _train(t_cli.main, ["--device", "cpu", "-b", "40"], str(tmp_path / "c.dat"), p)
    _, g_g = _train(t_cli.main, ["--device", "cuda", "-b", "40"], str(tmp_path / "g.dat"), p)
    assert np.abs(c_g - g_g).max() <= BAND
