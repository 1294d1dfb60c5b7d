"""The slice as a whole: the port's stem_kernel_lite CLI against the JAX CLI.

Both CLIs read the same FASTA files.  The port runs with ``--device cpu``
(its plain torch versions) and both with ``--precision highest``.  The
normalized matrices must agree within 1.4e-2 max abs, the cross-backend
band of stem_kernel_lite (fold BPP f32 deltas amplified through the DAG
node weights).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from stem_kernel_tpu.cli import stem_kernel_lite as j_cli
from stem_kernel_torch.cli import stem_kernel_lite as t_cli
from stem_kernel_torch.cli import svm_tools
from stem_kernel_torch.gram.io import read_precomputed
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

CLI_BAND = 1.4e-2
CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    made these small folds many times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _data(tmp_path, n=4, seed=9):
    rng = np.random.default_rng(seed)

    def mutate(s):
        s = "".join(rng.choice(list("acgu")) if rng.random() < 0.1 else c for c in s)
        cut = int(rng.integers(0, 12))  # lengths 35..59
        return s[cut:] if rng.random() < 0.5 else s + "acgu"[: cut % 5] * 3

    pos = [mutate(CORE) for _ in range(n)]
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    assert all(30 <= len(s) <= 60 for s in pos + neg)
    paths = {}
    for name, seqs in (("pos", pos), ("neg", neg), ("tpos", pos[:2]), ("tneg", neg[:1])):
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths[name] = str(f)
    return paths


def _train_args(out, p):
    return ["--precision", "highest", "-n", out, "+1", p["pos"], "-1", p["neg"]]


def test_train_flow_matches_jax_cli(tmp_path):
    p = _data(tmp_path)
    t_out, j_out = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    assert t_cli.main(["--device", "cpu", *_train_args(t_out, p)]) == 0
    assert j_cli.main(_train_args(j_out, p)) == 0
    t_labels, t_g = read_precomputed(t_out)
    j_labels, j_g = read_precomputed(j_out)
    assert t_labels == j_labels == ["+1"] * 4 + ["-1"] * 4
    assert t_g.shape == (8, 8) and np.isfinite(t_g).all()
    np.testing.assert_allclose(np.diag(t_g), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t_g, t_g.T, atol=1e-7)
    assert np.abs(t_g - j_g).max() <= CLI_BAND


def test_predict_flow_matches_jax_cli(tmp_path):
    p = _data(tmp_path)
    km, model = str(tmp_path / "km.dat"), str(tmp_path / "km.model")
    assert t_cli.main(["--device", "cpu", *_train_args(km, p)]) == 0
    assert svm_tools.train_main([km, model]) == 0
    outs = {}
    for tag, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        rows, pred, norm = (str(tmp_path / f"{tag}_{f}") for f in ("rows.dat", "pred", "norm"))
        assert main([*extra, "--precision", "highest", "-n", rows, "--model", model,
                     "--predict", pred, "-x", norm, "--stream-chunk", "2",
                     "+1", p["pos"], "-1", p["neg"],
                     "--test", "+1", p["tpos"], "-1", p["tneg"]]) == 0
        labels, r = read_precomputed(rows)
        decs = [float(line.split()[1]) for line in open(pred).read().splitlines()]
        outs[tag] = (labels, r, np.asarray(decs), np.loadtxt(norm))
    (tl, tr, td, tn), (jl, jr, jd, jn) = outs["t"], outs["j"]
    assert tl == jl == ["+1", "+1", "-1"]
    assert tr.shape == jr.shape == (3, 8) and np.isfinite(tr).all()
    assert np.abs(tr - jr).max() <= CLI_BAND
    # a decision value sums coef * K over <= 8 SVs with |coef| <= C = 1
    np.testing.assert_allclose(td, jd, atol=8 * CLI_BAND)
    np.testing.assert_allclose(tn, jn, rtol=1e-3)


def test_gram_is_bit_identical_across_batch_sizes():
    from stem_kernel_torch.gram.bucketed import bucketed_gram
    from stem_kernel_torch.gram.engine import PairKernelEngine
    from stem_kernel_torch.io.profile import Alignment
    from stem_kernel_torch.models.composite import (
        StemLiteConfig, featurize_stem_bucketed, featurize_stem_examples,
        make_stem_lite_kernel_fn,
    )

    seqs = ["gggaaaccc", "gcgcaaagcgc", "ggcaaagccaugcaaaagcauggcaaagccaugcaaaagcau",
            "gggcuauuagcucagugguagagcgcgugcuuagcaugcac", "acguacguacgu", CORE]
    alns = [Alignment(rows=[s]) for s in seqs]
    cfg = StemLiteConfig(node_pad_multiple=8)
    buckets = featurize_stem_bucketed(alns, cfg, device="cpu")
    assert len(buckets) >= 2
    make = lambda it: make_stem_lite_kernel_fn(cfg, it, device="cpu")  # noqa: E731
    g3 = bucketed_gram(buckets, make, device="cpu", normalize=True, batch_size=3)
    g256 = bucketed_gram(buckets, make, device="cpu", normalize=True, batch_size=256)
    assert np.array_equal(g3, g256)
    feats, iters = featurize_stem_examples(alns, cfg, device="cpu")
    flat = [PairKernelEngine(make(iters), feats, device="cpu", batch_size=bs).gram(normalize=True)
            for bs in (2, 64)]
    assert np.array_equal(flat[0], flat[1])
    np.testing.assert_allclose(g3, flat[0], rtol=2e-4, atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stem_kernel_torch\n"
        "import stem_kernel_torch.cli.stem_kernel_lite\n"
        "import stem_kernel_torch.cli.bpla_optimizer, stem_kernel_torch.cli.classic_optimizers\n"
        "import stem_kernel_torch.cli.la_kernel_lite, stem_kernel_torch.cli.string_kernel\n"
        "import stem_kernel_torch.cli.simpal, stem_kernel_torch.opt.kernel_entropy\n"
        "import stem_kernel_torch.native, stem_kernel_torch.native.build\n"
        "import stem_kernel_torch.cli.utils_cli, stem_kernel_torch.utils.tracing\n"
        "import stem_kernel_torch.gram.checkpoint, stem_kernel_torch.utils.transforms\n"
        "for m in pkgutil.walk_packages(stem_kernel_torch.__path__, 'stem_kernel_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'stem_kernel_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_cuda_without_gpu_raises(tmp_path, monkeypatch):
    p = _data(tmp_path, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--device", "cuda", "-n", str(tmp_path / "k.dat"),
                    "+1", p["pos"], "-1", p["neg"]])


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--single-device"], ["--coarse-shapes"]])
def test_unported_options_are_rejected(tmp_path, flag, capsys):
    """--coarse-shapes, a TPU compile-count option, is a usage error.  In one
    process, --devices 2 raises, naming the torchrun launch of two ranks,
    and --single-device writes the matrix of the run without it."""
    p = _data(tmp_path, n=1)
    args = ["+1", p["pos"], "-1", p["neg"]]
    out = str(tmp_path / "k.dat")
    if flag == ["--coarse-shapes"]:
        with pytest.raises(SystemExit) as exc:
            t_cli.main(["--device", "cpu", *flag, "-n", out, *args])
        assert exc.value.code == 2
        assert flag[0] in capsys.readouterr().err
    elif flag == ["--devices", "2"]:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            t_cli.main(["--device", "cpu", *flag, "-n", out, *args])
    else:
        plain = str(tmp_path / "plain.dat")
        assert t_cli.main(["--device", "cpu", *flag, "-n", out, *args]) == 0
        assert t_cli.main(["--device", "cpu", "-n", plain, *args]) == 0
        assert open(out, "rb").read() == open(plain, "rb").read()


@pytest.mark.parametrize("log_values", [False, True])
def test_pair_engine_matches_jax_engine(log_values):
    """gram (normalized and not), diagonal and rows with sv_index, on a
    kernel whose values come straight from the features."""
    import jax.numpy as jnp

    from stem_kernel_tpu.gram.engine import PairKernelEngine as JEngine
    from stem_kernel_torch.gram.engine import PairKernelEngine as TEngine

    rng = np.random.default_rng(4)
    train = rng.random((7, 5)).astype(np.float32)
    test = rng.random((3, 5)).astype(np.float32)
    sv = np.array([0, 2, 5])
    j = JEngine(lambda x, y: jnp.sum(x["v"] * y["v"], -1), {"v": train}, batch_size=4,
                log_values=log_values)
    t = TEngine(lambda x, y: (x["v"] * y["v"]).sum(-1), {"v": train}, device="cpu",
                batch_size=4, log_values=log_values)
    for normalize in (False, True):
        np.testing.assert_allclose(t.gram(normalize=normalize), j.gram(normalize=normalize),
                                   rtol=1e-6)
    np.testing.assert_allclose(t.diagonal(sv_index=sv), j.diagonal(sv_index=sv), rtol=1e-6)
    t_rows, t_self = t.rows({"v": test}, sv_index=sv)
    j_rows, j_self = j.rows({"v": test}, sv_index=sv)
    np.testing.assert_allclose(t_rows, j_rows, rtol=1e-6)
    np.testing.assert_allclose(t_self, j_self, rtol=1e-6)


# the fold flags of the fold slice, and stem_kernel_lite's other options
OPTION_CASES = {
    "use_alifold": ["--use-alifold"],
    "use_contrafold": ["--use-contrafold", "default"],
    "log": ["--log"],
    "no_ribosum": ["--no-ribosum"],
    "no_string": ["--no-string"],
    "fast_fold": ["--fast-fold"],
    "noGU_noLonelyPairs": ["--noGU", "--noLonelyPairs"],
    "log_no_ribosum": ["--log", "--no-ribosum"],
    "p_length_band": ["-p", "0.1", "--length-band", "0"],
}


@pytest.mark.parametrize("flags", list(OPTION_CASES.values()), ids=list(OPTION_CASES))
def test_options_match_jax_cli(tmp_path, flags):
    """Each option on a few sequences, the port on the CPU against the JAX
    CLI, within the 1.4e-2 band; ``--log`` runs unnormalised (the log
    kernel's cosine normalisation divides by log K(x, x), which is 0 on
    these short sequences in both packages) and is held to the band
    relative to its largest value."""
    p = _data(tmp_path, n=2)
    norm = [] if "--log" in flags else ["-n"]
    grams = {}
    for tag, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        out = str(tmp_path / f"{tag}.dat")
        assert main([*extra, *flags, "--precision", "highest", *norm, out,
                     "+1", p["pos"], "-1", p["neg"]]) == 0
        grams[tag] = read_precomputed(out)
    (tl, tg), (jl, jg) = grams["t"], grams["j"]
    assert tl == jl == ["+1"] * 2 + ["-1"] * 2
    assert tg.shape == (4, 4) and np.isfinite(tg).all()
    scale = np.abs(jg).max() if "--log" in flags else 1.0
    assert np.abs(tg - jg).max() <= CLI_BAND * scale


@pytest.mark.parametrize("svm_type", range(5))
def test_svm_tools_match_jax_svm_tools(tmp_path, svm_type):
    """svm_tools train and predict with -s 0..4 (C-SVC, nu-SVC, one-class,
    epsilon-SVR, nu-SVR): model and prediction files byte-equal, both
    packages on their native SMO."""
    from stem_kernel_torch.gram.io import write_precomputed, write_rows
    from stem_kernel_tpu.cli import svm_tools as j_svm

    rng = np.random.default_rng(20 + svm_type)
    x = rng.normal(size=(36, 3))
    k = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1))
    if svm_type < 3:
        labels = ["+1" if v > 0 else "-1" for v in x[:, 0] + 0.3 * x[:, 1]]
    else:
        labels = [f"{v:.4f}" for v in x[:, 0] - 0.5 * x[:, 2]]
    train, test = str(tmp_path / "k.dat"), str(tmp_path / "rows.dat")
    write_precomputed(train, labels[:30], k[:30, :30])
    write_rows(test, labels[30:], k[30:, :30])
    outs = {}
    for tag, mod in (("t", svm_tools), ("j", j_svm)):
        model, pred = str(tmp_path / f"{tag}.model"), str(tmp_path / f"{tag}.pred")
        assert mod.train_main(["-s", str(svm_type), train, model]) == 0
        assert mod.predict_main([test, model, pred]) == 0
        outs[tag] = (open(model, "rb").read(), open(pred, "rb").read())
    assert outs["t"] == outs["j"]
    assert len(outs["t"][1].splitlines()) == 6


@pytest.mark.parametrize("svm_type", [0, 1])
def test_svm_tools_probability_matches_jax_svm_tools(tmp_path, svm_type):
    """svm_tools train and predict with -b 1 (probability estimates) for
    C-SVC and nu-SVC: model and prediction files byte-equal, both packages
    on their native SMO."""
    from stem_kernel_torch.gram.io import write_precomputed, write_rows
    from stem_kernel_tpu.cli import svm_tools as j_svm

    rng = np.random.default_rng(30 + svm_type)
    x = rng.normal(size=(46, 3))
    k = np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1))
    labels = ["+1" if v > 0 else "-1" for v in x[:, 0] + 0.3 * x[:, 1] + 0.3 * rng.normal(size=46)]
    train, test = str(tmp_path / "k.dat"), str(tmp_path / "rows.dat")
    write_precomputed(train, labels[:40], k[:40, :40])
    write_rows(test, labels[40:], k[40:, :40])
    outs = {}
    for tag, mod in (("t", svm_tools), ("j", j_svm)):
        model, pred = str(tmp_path / f"{tag}.model"), str(tmp_path / f"{tag}.pred")
        assert mod.train_main(["-s", str(svm_type), "-b", "1", train, model]) == 0
        assert mod.predict_main(["-b", "1", test, model, pred]) == 0
        outs[tag] = (open(model, "rb").read(), open(pred, "rb").read())
    assert outs["t"] == outs["j"]
    assert b"probA" in outs["t"][0] and len(outs["t"][1].splitlines()) == 6
