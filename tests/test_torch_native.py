"""The port's native host code: the DAG scan and the SMO solvers.

The port builds its own library from ``stem_kernel_torch/native/*.cpp``
with the JAX package's compiler flags, so on one machine its DAG scan and
its solvers must equal the JAX package's native ones bit for bit.  Against
the plain versions (the Python scan, the numpy SMO) they are held to
``tests/test_native.py``'s bands: the scan exact, the SMO objective rtol
1e-8 with alpha and rho atol 1e-5, the nu-solver objective 1e-6 rel with
rho, r and alpha 1e-4.
"""

import subprocess
import sys

import numpy as np
import pytest

import stem_kernel_tpu.native as j_nat
import stem_kernel_torch.native as t_nat
from stem_kernel_torch.fold.bpmatrix import average_bpp, fold_sequences
from stem_kernel_torch.io.parsers import parse_clustal
from stem_kernel_torch.io.profile import Alignment
from stem_kernel_torch.models import dag as t_dag
from stem_kernel_torch.native import build as t_build
from stem_kernel_torch.svm import solver as t_sol

CLUSTAL = """CLUSTAL W (1.83) multiple sequence alignment

s1   GGGCGCAAGCUUGAAAGCGCCC-AUAGGCUAACGUAGCUAGCUUAAGC
s2   GGGCGC-AGCUUGAAAGCGCCCUAUAGGCUAACG-AGCUAGCUUAAGC
s3   GGACGCAAGCUU-AAAGCGUCCAAUAGGCUAAUGUAGCUAGCU-AAGC
"""


def _scans(bpp, th):
    L = bpp.shape[0]
    return (t_dag._dag_topology(bpp, L, th), t_dag._dag_topology_python(bpp, L, th),
            j_nat.dag_scan_native(bpp, th))


def _assert_scans_equal(bpp, th):
    got, plain, jax_native = _scans(bpp, th)
    assert len(got) == len(plain) == len(jax_native) == 5
    for a, b, c in zip(got, plain, jax_native):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    return got


def _random_bpp(seed, L):
    """Upper-triangular random probabilities with a few strong stems."""
    r = np.random.default_rng(seed)
    bpp = np.triu(r.uniform(0.0, 0.02, (L, L)), 1)
    for _ in range(4):
        i, j = sorted(r.integers(0, L, 2))
        for k in range(min(5, (j - i) // 2)):
            bpp[i + k, j - k] = r.uniform(0.2, 0.9)
    return bpp


def test_dag_scan_on_folded_sequences():
    seqs = ["gggaaaccc", "gggcuauuagcucaguggua",
            "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagcggcaaagccaugcaaaagcau",
            "acguacguacgu"]
    for seq, bpp in zip(seqs, fold_sequences(seqs, device="cpu")):
        for th in (0.01, 0.001):
            first = _assert_scans_equal(bpp, th)[0]
            assert len(first) >= 1


def test_dag_scan_on_alignment_column_bpp():
    rows = [s for _, s in parse_clustal(CLUSTAL)[0]]
    aln = Alignment(rows=rows)
    avg = average_bpp(aln, fold_sequences(aln.ungapped_rows(), device="cpu"))
    assert avg.shape == (aln.length, aln.length)
    got = _assert_scans_equal(avg, 0.01)
    assert len(got[2]) > 0  # edges


@pytest.mark.parametrize("th", [0.01, 0.1])
def test_dag_scan_on_random_matrices(th):
    for seed, L in ((1, 1), (2, 7), (3, 60), (4, 150)):
        _assert_scans_equal(_random_bpp(seed, L), th)
    _assert_scans_equal(np.zeros((12, 12)), th)  # unstructured: a single leaf


def _svm_problem(n=40, seed=3):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 3))
    X[: n // 2] += 1.2
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])
    return X @ X.T, y


def _nu_problem(n=30, seed=3):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 4))
    X[: n // 2] += 1.1
    K = X @ X.T + n * np.eye(n) * 1e-6
    y = np.array([1.0] * (n // 2) + [-1.0] * (n // 2))
    s = 0.4 * n / 2  # a feasible nu-SVC start, nu = 0.4, C = 1
    a0 = np.full(n, min(1.0, s / (n // 2)))
    return K, y, a0


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_smo_equals_jax_native_bitwise(dtype):
    K, y = _svm_problem()
    K = K.astype(dtype)
    p = -np.ones(len(y))
    for C_p, C_n, eps in ((1.0, 1.0, 1e-6), (10.0, 2.5, 1e-3)):
        got = t_sol.smo_solve(K, y, p, C_p, C_n, eps=eps)
        want = j_nat.smo_solve_native(K, y, p, C_p, C_n, eps, max(10_000_000, 100 * len(y)))
        np.testing.assert_array_equal(got.alpha, want[0])
        assert (got.rho, got.obj, got.n_iter) == tuple(want[1:])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_smo_nu_equals_jax_native_bitwise(dtype):
    K, y, a0 = _nu_problem()
    K = K.astype(dtype)
    got, r = t_sol.smo_solve_nu(K, y, np.zeros(len(y)), 1.0, 1.0, a0, eps=1e-4)
    want = j_nat.smo_solve_nu_native(K, y, np.zeros(len(y)), 1.0, 1.0, a0, 1e-4,
                                     max(10_000_000, 100 * len(y)))
    np.testing.assert_array_equal(got.alpha, want[0])
    assert (got.rho, r, got.obj, got.n_iter) == tuple(want[1:])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_smo_native_against_numpy(dtype):
    K, y = _svm_problem()
    K = K.astype(dtype)
    p = -np.ones(len(y))
    nat = t_sol.smo_solve(K, y, p, 1.0, 1.0, eps=1e-6)
    plain = t_sol.smo_solve_numpy(K, y, p, 1.0, 1.0, eps=1e-6)
    np.testing.assert_allclose(nat.obj, plain.obj, rtol=1e-8)
    np.testing.assert_allclose(nat.alpha, plain.alpha, atol=1e-5)
    np.testing.assert_allclose(nat.rho, plain.rho, atol=1e-5)
    # the numpy path equals the JAX package's numpy path bit for bit
    from stem_kernel_tpu.svm import solver as j_sol

    saved = j_nat.smo_solve_native
    j_nat.smo_solve_native = lambda *a, **k: None
    try:
        j_plain = j_sol.smo_solve(K, y, p, 1.0, 1.0, eps=1e-6)
    finally:
        j_nat.smo_solve_native = saved
    np.testing.assert_array_equal(plain.alpha, j_plain.alpha)
    assert (plain.rho, plain.obj, plain.n_iter) == (j_plain.rho, j_plain.obj, j_plain.n_iter)


def test_smo_warm_start_takes_the_numpy_path():
    K, y = _svm_problem(n=20)
    a0 = np.full(len(y), 0.05)
    got = t_sol.smo_solve(K, y, -np.ones(len(y)), 1.0, 1.0, alpha0=a0)
    want = t_sol.smo_solve_numpy(K, y, -np.ones(len(y)), 1.0, 1.0, alpha0=a0)
    np.testing.assert_array_equal(got.alpha, want.alpha)
    assert (got.rho, got.obj, got.n_iter) == (want.rho, want.obj, want.n_iter)


def test_smo_nu_native_against_numpy():
    K, y, a0 = _nu_problem()
    p = np.zeros(len(y))
    nat, r_nat = t_sol.smo_solve_nu(K, y, p, 1.0, 1.0, a0, eps=1e-4)
    plain, r_plain = t_sol.smo_solve_nu_numpy(K, y, p, 1.0, 1.0, a0, eps=1e-4)
    assert abs(nat.obj - plain.obj) <= 1e-6 * max(1.0, abs(plain.obj))
    assert abs(nat.rho - plain.rho) <= 1e-4
    assert abs(r_nat - r_plain) <= 1e-4
    np.testing.assert_allclose(nat.alpha, plain.alpha, atol=1e-4)


def test_smo_rejects_mismatched_shapes():
    K, y = _svm_problem(n=10)
    with pytest.raises(ValueError, match="SMO inputs"):
        t_nat.smo_solve_native(K[:9], y, -np.ones(10), 1.0, 1.0, 1e-3, 1000)


def test_port_never_loads_the_jax_library():
    code = (
        "import numpy as np\n"
        "from stem_kernel_torch.models.dag import _dag_topology\n"
        "from stem_kernel_torch.svm.solver import smo_solve\n"
        "_dag_topology(np.eye(5) * 0.5, 5, 0.01)\n"
        "smo_solve(np.eye(4), np.array([1.0, 1, -1, -1]), -np.ones(4), 1.0, 1.0)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('libsktnative_torch.so' in maps, 'libsktnative.so' in maps)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False"]


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without g++ the build raises, and so does every native entry point:
    nothing falls back to the Python scan or the numpy SMO."""
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ here
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "build")  # nothing built
    t_nat.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            t_build.build()
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            t_dag._dag_topology(np.eye(5) * 0.5, 5, 0.01)
        K, y = _svm_problem(n=10)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            t_sol.smo_solve(K, y, -np.ones(10), 1.0, 1.0)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            t_sol.smo_solve_nu(K, y, np.zeros(10), 1.0, 1.0, np.full(10, 0.2))
    finally:
        t_nat.load_library.cache_clear()


def test_compiler_error_is_raised_with_its_output(tmp_path, monkeypatch):
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "smo.cpp").write_text("this is not C++\n")
    (bad / "dagscan.cpp").write_text("\n")
    monkeypatch.setattr(t_build, "NATIVE_DIR", bad)
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
        t_build.build()
    assert "smo.cpp" in str(exc.value)
    assert not (tmp_path / "build" / t_build.LIB_NAME).exists()
