"""Port parity: the CONTRAfold model (weights, files, mapping, inference,
trainer) and the ``--use-contrafold`` CLI flag.

The port against the JAX package on the same numpy inputs: parameter files
written byte for byte alike and read back equal, sniffed alike;
``contrafold_energy_params`` tables equal; ``contrafold_bpp`` within 2e-5 of
the ``contra_*`` goldens (the JAX package's own band,
tests/test_fold_goldens.py); ``cf_logZ`` and its gradient against
``jax.value_and_grad`` on random weights in f64 within 1e-8 rel (measured
6e-16); ``train_contrafold`` loss history within 1e-8 rel of JAX's (measured
4e-16, f64 in both, conftest enables x64); ``stem_kernel_lite
--use-contrafold default`` against the JAX CLI within the 1.4e-2 band of
stem_kernel_lite (measured 2.7e-7 on these files), also under ``--noGU``,
which must keep the CONTRAfold model as the JAX CLI does.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from stem_kernel_tpu.fold import contrafold as J
from stem_kernel_torch.fold import contrafold as T
from stem_kernel_torch.gram.io import read_precomputed

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "method_bpp.npz")
MDATA = np.load(GOLDEN)
CONTRA_NAMES = sorted({k.split("__")[0] for k in MDATA.files if k.startswith("contra_")})
GOLDEN_ATOL = 2e-5
F64_RTOL = 1e-8
CLI_BAND = 1.4e-2
EXAMPLES = [("gggaaacccaaa", "(((...)))..."), ("ggcgaaacgcc", "((((...))))")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    made these small folds many times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _random_weights(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    v = J.weights_to_vector(J.default_weights())
    return v + rng.normal(0.0, scale, v.shape)


def test_schema_and_vectors_match_jax():
    assert T.SCHEMA == J.SCHEMA
    for name in ("zero_weights", "default_weights"):
        got, want = getattr(T, name)(), getattr(J, name)()
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    v = _random_weights(1)
    np.testing.assert_array_equal(T.weights_to_vector(T.vector_to_weights(v)), v)
    np.testing.assert_array_equal(T.weights_to_vector(J.default_weights()),
                                  J.weights_to_vector(J.default_weights()))


def test_params_file_roundtrip_and_sniffing(tmp_path):
    from stem_kernel_tpu.fold.params import load_params_file as j_load_params_file
    from stem_kernel_torch.fold.params import load_params_file

    w = T.vector_to_weights(_random_weights(2))
    t_path, j_path = tmp_path / "t.params", tmp_path / "j.params"
    T.save_contrafold_params(str(t_path), w)
    J.save_contrafold_params(str(j_path), w)
    assert t_path.read_bytes() == j_path.read_bytes()
    back = T.load_contrafold_params(str(t_path))
    want = J.load_contrafold_params(str(t_path))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
        np.testing.assert_allclose(back[k], w[k], rtol=1e-9, atol=1e-12)
    # cumulative length features and a non-canonical feature's error
    (tmp_path / "cum.params").write_text(
        "hairpin_length_at_least_5 0.25\nbase_pair_GC 1.5\nmulti_base -1\n")
    got = T.load_contrafold_params(str(tmp_path / "cum.params"))
    want = J.load_contrafold_params(str(tmp_path / "cum.params"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "bad.params").write_text("base_pair_AA 1.0\n")
    with pytest.raises(ValueError, match="bad.params:1"):
        T.load_contrafold_params(str(tmp_path / "bad.params"))
    (tmp_path / "simple.params").write_text("ml_close 3.4\n")
    for path in (t_path, tmp_path / "cum.params", tmp_path / "simple.params",
                 tmp_path / "missing.params"):
        assert T.is_contrafold_params(str(path)) == J.is_contrafold_params(str(path))
    assert T.is_contrafold_params(str(t_path))
    assert not T.is_contrafold_params(str(tmp_path / "simple.params"))
    # load_params_file takes the CONTRAfold branch on a weight file
    got_p, want_p = load_params_file(str(t_path)), j_load_params_file(str(t_path))
    np.testing.assert_array_equal(got_p.stack, want_p.stack)
    assert got_p.mismatch_all_hairpins and got_p.bulge1_no_stack


@pytest.mark.parametrize("seed", [None, 3])
def test_energy_params_tables_match_jax(seed):
    w = J.default_weights() if seed is None else J.vector_to_weights(_random_weights(seed))
    got, want = T.contrafold_energy_params(w), J.contrafold_energy_params(w)
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("name", CONTRA_NAMES)
def test_contrafold_bpp_matches_golden(name):
    seq = MDATA[f"{name}__seq"].tobytes().decode()
    got = T.contrafold_bpp([seq], device="cpu")[0]
    assert got.dtype == np.float64 and got.shape == (len(seq), len(seq))
    np.testing.assert_allclose(got, MDATA[f"{name}__bpp"], atol=GOLDEN_ATOL)


def test_parse_dotbracket_matches_jax():
    for db in ("((..))", "(((...)))...((..))", "...."):
        assert T.parse_dotbracket(db) == J.parse_dotbracket(db)
    with pytest.raises(ValueError):
        T.parse_dotbracket("((.)")


def test_cf_logZ_and_gradient_match_jax():
    import jax
    import jax.numpy as jnp

    vec = _random_weights(4)
    codes = np.random.default_rng(5).integers(0, 4, 12)
    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda v: J.cf_logZ(J.vector_to_weights(v), codes)))(jnp.asarray(vec))
    tv = torch.tensor(vec, requires_grad=True)
    t_val = T.cf_logZ(T.vector_to_weights(tv), codes)
    (t_grad,) = torch.autograd.grad(t_val, tv)
    assert t_val.dtype == torch.float64
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=F64_RTOL)
    j_grad = np.asarray(j_grad)
    assert np.abs(t_grad.numpy() - j_grad).max() <= F64_RTOL * np.abs(j_grad).max()
    # the structure score of a helix, and the engine logZ under the mapping
    pairs = T.parse_dotbracket("((((....))))")
    codes2 = np.array([2, 2, 2, 2, 0, 0, 0, 0, 1, 1, 1, 1])
    w = T.vector_to_weights(torch.tensor(vec))
    np.testing.assert_allclose(
        T.cf_structure_score(w, codes2, pairs).item(),
        float(J.cf_structure_score(J.vector_to_weights(jnp.asarray(vec)), codes2, pairs)),
        rtol=F64_RTOL)
    from stem_kernel_torch.fold.mccaskill import mccaskill_logZ

    engine = mccaskill_logZ(codes, params=T.contrafold_energy_params(T.vector_to_weights(vec)),
                            dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(engine, t_val.item(), rtol=1e-10)


def test_train_contrafold_matches_jax():
    j_w, j_hist = J.train_contrafold(EXAMPLES, steps=3)
    t_w, t_hist = T.train_contrafold(EXAMPLES, steps=3, device="cpu")
    assert len(t_hist) == 3 and t_hist[-1] < t_hist[0]
    np.testing.assert_allclose(t_hist, j_hist, rtol=F64_RTOL)
    for k in j_w:
        np.testing.assert_allclose(t_w[k], j_w[k], rtol=F64_RTOL, atol=1e-12)


def _fold_ns(**kw):
    base = dict(use_alifold=False, use_contrafold=None, noGU=False, noClosingGU=False,
                noLonelyPairs=False, fast_fold=False)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("gate", ["noGU", "noClosingGU", "noLonelyPairs"])
def test_fold_opts_keep_the_chosen_model_under_gates(tmp_path, gate):
    """The gates apply to the model already chosen, as JAX's fold_opts_from
    does: --use-contrafold default --noGU folds CONTRAfold, not Turner."""
    from stem_kernel_tpu.cli.stem_kernel_lite import fold_opts_from as j_fold_opts_from
    from stem_kernel_torch.cli.stem_kernel_lite import fold_opts_from

    path = tmp_path / "w.params"
    T.save_contrafold_params(str(path), T.default_weights())
    for model in ("default", str(path)):
        ns = _fold_ns(use_contrafold=model, **{gate: True})
        got, want = fold_opts_from(ns).params, j_fold_opts_from(ns).params
        assert got.mismatch_all_hairpins and got.bulge1_no_stack
        for f in want.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=f)
            else:
                assert a == b, f


@pytest.mark.parametrize("flags", [["--use-contrafold", "default", "--noGU"],
                                   ["--use-contrafold", "FILE"]], ids=["default_noGU", "file"])
def test_stem_kernel_lite_use_contrafold_matches_jax_cli(tmp_path, flags):
    from stem_kernel_tpu.cli import stem_kernel_lite as j_cli
    from stem_kernel_torch.cli import stem_kernel_lite as t_cli
    from test_torch_cli import _data

    p = _data(tmp_path, n=2)
    path = tmp_path / "w.params"
    T.save_contrafold_params(str(path), T.default_weights())
    flags = [str(path) if f == "FILE" else f for f in flags]
    outs = {}
    for tag, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        out = str(tmp_path / f"{tag}.dat")
        assert main([*extra, *flags, "--precision", "highest", "-n", out,
                     "+1", p["pos"], "-1", p["neg"]]) == 0
        outs[tag] = read_precomputed(out)[1]
    assert outs["t"].shape == (4, 4) and np.isfinite(outs["t"]).all()
    assert np.abs(outs["t"] - outs["j"]).max() <= CLI_BAND
    if "--noGU" in flags:
        # the repair: --noGU kept the CONTRAfold model (a Turner fold differs)
        out = str(tmp_path / "turner.dat")
        assert t_cli.main(["--device", "cpu", "--noGU", "--precision", "highest", "-n", out,
                           "+1", p["pos"], "-1", p["neg"]]) == 0
        assert np.abs(read_precomputed(out)[1] - outs["t"]).max() > 1e-4
    else:
        # a weight file of the default weights folds as the literal 'default'
        out = str(tmp_path / "default.dat")
        assert t_cli.main(["--device", "cpu", "--use-contrafold", "default", "--precision",
                           "highest", "-n", out, "+1", p["pos"], "-1", p["neg"]]) == 0
        assert open(out, "rb").read() == open(str(tmp_path / "t.dat"), "rb").read()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_cuda_trainer_and_bpp_match_cpu():
    _, cpu_hist = T.train_contrafold(EXAMPLES, steps=2, device="cpu")
    _, card_hist = T.train_contrafold(EXAMPLES, steps=2, device="cuda")
    np.testing.assert_allclose(card_hist, cpu_hist, rtol=1e-9)
    for name in CONTRA_NAMES:
        seq = MDATA[f"{name}__seq"].tobytes().decode()
        np.testing.assert_allclose(T.contrafold_bpp([seq], device="cuda")[0],
                                   MDATA[f"{name}__bpp"], atol=GOLDEN_ATOL)
