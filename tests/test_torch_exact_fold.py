"""Port parity: the exact log-space fold (the oracle) and SFOLD sampling.

The port's exact fold in f64 against ``tests/golden/fold_bpp.npz`` at the
JAX oracle's own tolerances (rtol 1e-10 on logZ, atol 1e-10 on BPP,
tests/test_fold_goldens.py), against the JAX oracle with extra pair weights
and pair-type overrides (1e-10), and against the port's scaled f32 engine
at the fold bands (BPP atol 5e-4, logZ rtol 2e-5).  ``sfold_bpp`` must
reproduce the ``sfold_*`` goldens bit for bit: its inside tables are the
exact fold's, and its traceback draws from ``np.random.default_rng(seed)``
as the JAX package's does.
"""

import os

import numpy as np
import pytest
import torch

from stem_kernel_torch.fold.bpmatrix import BPMatrixOptions, fold_sequences
from stem_kernel_torch.fold.mccaskill import mccaskill_bpp, mccaskill_bpp_batch, mccaskill_logZ
from stem_kernel_torch.fold.sampling import sample_structures, sfold_bpp
from stem_kernel_torch.io.alphabet import encode

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fold_bpp.npz")
DATA = np.load(GOLDEN)
METHOD = np.load(os.path.join(os.path.dirname(__file__), "golden", "method_bpp.npz"))
SFOLD_NAMES = sorted({k.split("__")[0] for k in METHOD.files if k.startswith("sfold_")})
GOLDEN_CASES = ["au_control", "hammerhead", "junction3"]  # 62, 64, 84 nt
ORACLE_TOL = 1e-10
BPP_ATOL, LOGZ_RTOL = 5e-4, 2e-5  # the scaled f32 engine against the oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    made these small folds many times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seq(name):
    return DATA[f"{name}__seq"].tobytes().decode()


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_exact_fold_matches_golden_f64(name):
    bpp, logz = mccaskill_bpp(encode(_seq(name)), dtype=torch.float64, device="cpu")
    assert bpp.dtype == np.float64
    np.testing.assert_allclose(logz, DATA[f"{name}__logz"], rtol=ORACLE_TOL)
    np.testing.assert_allclose(bpp, DATA[f"{name}__bpp"], atol=ORACLE_TOL)
    assert mccaskill_logZ(encode(_seq(name)), dtype=torch.float64, device="cpu") == logz


def test_exact_fold_with_overrides_matches_jax_oracle():
    """w_extra and pt_override through both oracles (f64)."""
    import jax.numpy as jnp

    from stem_kernel_tpu.fold.mccaskill import mccaskill_bpp as j_mccaskill_bpp
    from stem_kernel_torch.fold.params import PAIR_TYPE

    codes = encode("gggaaaaaacccagcuuagc")
    n = len(codes)
    pt = PAIR_TYPE[codes[:, None], codes[None, :]].copy()
    pt[3, 8], pt[8, 3] = 4, 5  # force A:U typing for a:a
    w_extra = np.random.default_rng(2).normal(0.0, 0.5, (n, n)).astype(np.float32)
    got, gz = mccaskill_bpp(codes, w_extra=w_extra, pt_override=pt, dtype=torch.float64,
                            device="cpu")
    want, wz = j_mccaskill_bpp(codes, w_extra=w_extra, pt_override=pt, dtype=jnp.float64)
    np.testing.assert_allclose(gz, wz, rtol=ORACLE_TOL)
    np.testing.assert_allclose(got, np.asarray(want), atol=ORACLE_TOL)


def test_log_engine_batch_matches_single_and_scaled_engine():
    seqs = [_seq(n) for n in GOLDEN_CASES[:2]] + ["gggaaaccc"]
    nmax = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), nmax), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = encode(s)
    b_log, z_log = mccaskill_bpp_batch(codes, lens, engine="log", dtype=torch.float64,
                                       device="cpu")
    b_sc, z_sc = mccaskill_bpp_batch(codes, lens, device="cpu")
    assert b_log.dtype == torch.float64 and b_sc.dtype == torch.float32
    for i, s in enumerate(seqs):
        one, z = mccaskill_bpp(encode(s), dtype=torch.float64, device="cpu")
        m = len(s)
        np.testing.assert_allclose(b_log[i, :m, :m].numpy(), one, atol=1e-12)
        np.testing.assert_allclose(z_log[i].item(), z, rtol=1e-12)
        np.testing.assert_allclose(z_sc[i].item(), z, rtol=LOGZ_RTOL)
        np.testing.assert_allclose(b_sc[i, :m, :m].numpy(), one, atol=BPP_ATOL)
    with pytest.raises(ValueError, match="engine"):
        mccaskill_bpp_batch(codes, lens, engine="fast", device="cpu")


@pytest.mark.parametrize("name", SFOLD_NAMES)
def test_sfold_matches_golden_bit_for_bit(name):
    """Pair counts are integers: the pin is bit-exact, as in JAX."""
    seq = METHOD[f"{name}__seq"].tobytes().decode()
    bpp = sfold_bpp(seq, 200, seed=0, device="cpu")
    np.testing.assert_array_equal(bpp, METHOD[f"{name}__bpp"])


def test_fold_sequences_samples_with_n_samples():
    seq = METHOD["sfold_hairpin__seq"].tobytes().decode()
    got = fold_sequences([seq], BPMatrixOptions(n_samples=200), device="cpu")[0]
    np.testing.assert_array_equal(got, METHOD["sfold_hairpin__bpp"])


def test_samples_are_valid_structures():
    seq = "gggcgcaagcuugaaagcgccc"
    codes = encode(seq)
    from stem_kernel_torch.fold.params import PAIR_TYPE

    for pairs in sample_structures(seq, 50, seed=3, device="cpu"):
        used = [k for p in pairs for k in p]
        assert len(used) == len(set(used))
        for i, j in pairs:
            assert j - i > 3 and PAIR_TYPE[codes[i], codes[j]] >= 0
        for (i, j) in pairs:  # nested: no crossing pairs
            for (k, l) in pairs:
                assert not (i < k < j < l)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_cuda_exact_fold_and_sfold():
    for name in GOLDEN_CASES:
        bpp, logz = mccaskill_bpp(encode(_seq(name)), dtype=torch.float64, device="cuda")
        np.testing.assert_allclose(logz, DATA[f"{name}__logz"], rtol=ORACLE_TOL)
        np.testing.assert_allclose(bpp, DATA[f"{name}__bpp"], atol=ORACLE_TOL)
    for name in SFOLD_NAMES:
        seq = METHOD[f"{name}__seq"].tobytes().decode()
        np.testing.assert_array_equal(sfold_bpp(seq, 200, seed=0, device="cuda"),
                                      METHOD[f"{name}__bpp"])
