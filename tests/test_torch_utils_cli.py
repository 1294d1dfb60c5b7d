"""The port's utils CLI against the JAX package's, subcommand by subcommand.

Both read the same input files (made from a seed with numpy, as in
``tests/test_utils_cli.py``); their output files and standard output must
be byte-equal.
"""

import numpy as np
import pytest

from stem_kernel_tpu.cli import utils_cli as j_utils
from stem_kernel_torch.cli import utils_cli as t_utils
from stem_kernel_torch.gram.io import write_precomputed

FASTA = (">a\nacguacguacgugcaugc\n>b\nggggccccaaaauuuu\n"
         ">c\nACGUACGGUUCAACGGAUUACGAUCCGAUGCAU\n>d\ngggcgcaagcuugaaagcgccc\n")
CLUSTAL = ("CLUSTAL W (1.83) multiple sequence alignment\n\n"
           "s1  ACGUACGUACGUACGU\n"
           "s2  ACGU-CGUACGAACGU\n"
           "s3  ACGUACGUACGCACG-\n")


def _inputs(tmp_path):
    r = np.random.default_rng(31)
    n = 5
    g = r.uniform(0.5, 2.0, (n, n))
    g = (g + g.T) / 2 + n * np.eye(n)
    files = {"m": tmp_path / "m.dat", "ts": tmp_path / "ts.dat", "rect": tmp_path / "rect.dat"}
    write_precomputed(str(files["m"]), ["+1"] * 2 + ["-1"] * 3, g)
    write_precomputed(str(files["ts"]), ["+1", "-1"], r.uniform(0.1, 1.0, (2, n)))
    write_precomputed(str(files["rect"]), ["+1", "-1", "+1"],
                      np.arange(12, dtype=np.float64).reshape(3, 4))
    texts = {
        "norm": "2.0\n3.0\n",
        "dec": "1 2.0\n1 1.5\n-1 -0.5\n-1 0.1\n1 -0.2\n",
        "cv": "== 0 1 1.2\n== 0 -1 -0.3\n== 1 1 0.8\n== 1 -1 0.9\nCross validation done\n",
        "ans": "1\n1\n-1\n-1\n",
        "pred": "labels 1 -1\n1 0.9 0.1\n1 0.8 0.2\n-1 0.3 0.7\n1 0.6 0.4\n",
        "fa": FASTA,
        "aln": CLUSTAL,
    }
    for name, text in texts.items():
        files[name] = tmp_path / f"in.{name}"
        files[name].write_text(text)
    return {k: str(v) for k, v in files.items()}


# subcommand -> (arguments before the output file, output file or None for stdout, after)
CASES = {
    "roc": (["dec"], None, []),
    "roc-cv": (["cv"], None, []),
    "roc-p": (["ans", "pred"], None, []),
    "normalize-matrix": (["m"], "out", []),
    "normalize-test-matrix": (["m", "norm", "ts"], "out", []),
    "radial-basis-matrix": (["0.1", "m"], "out", []),
    "submatrix": (["3", "m"], "out", []),
    "submatrix-test": (["2", "rect"], "out", []),
    "dishuffle": (["fa"], "out", ["7"]),
    "dishuffle-aln": (["aln"], "out", ["11"]),
    "dishuffle-fa-pos": (["fa"], "out", ["3"]),
    "fa-sampling": (["2", "fa"], "out", ["3"]),
    "mean-id": (["fa"], None, []),
}


def test_every_subcommand_is_covered():
    assert set(CASES) == set(j_utils._COMMANDS) == set(t_utils._COMMANDS)


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_subcommand_output_is_byte_equal(cmd, tmp_path, capsys):
    files = _inputs(tmp_path)
    before, out, after = CASES[cmd]
    results = []
    for tag, mod in (("j", j_utils), ("t", t_utils)):
        argv = [cmd, *(files.get(a, a) for a in before)]
        if out:
            argv.append(str(tmp_path / f"{tag}.{out}"))
        assert mod.main([*argv, *after]) == 0
        stdout = capsys.readouterr().out
        results.append(open(argv[-1], "rb").read() if out else stdout.encode())
    assert results[0] == results[1]
    assert results[1]


@pytest.mark.parametrize("argv,rc", [([], 1), (["nope"], 1), (["submatrix"], 2),
                                     (["submatrix", "x", "m.dat"], 2),
                                     (["mean-id", "missing.fa"], 2)])
def test_usage_errors_match_jax(argv, rc, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    errs = []
    for mod in (j_utils, t_utils):
        assert mod.main(argv) == rc
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[1]


def test_p_norm_matches_jax():
    for y in (-0.45, -0.2, 0.0, 0.1, 0.3, 0.49):
        assert t_utils.p_norm(y) == j_utils.p_norm(y)
        assert abs(t_utils._norm_tail(t_utils.p_norm(y)) - y) < 1e-9
