"""One-class SVM, epsilon-SVR, nu-SVC and nu-SVR on precomputed kernels.

The reference's bundled LIBSVM carries all five machine types
(stem_kernel/libsvm/svm.h:21 `enum { C_SVC, NU_SVC, ONE_CLASS,
EPSILON_SVR, NU_SVR }`, qmatrix.h:64-110, svm.cpp solve_one_class /
solve_epsilon_svr / solve_nu_svc / solve_nu_svr); its own workflows only ever
train C-SVC, but the library surface exists, so this framework provides the
same extra machine types through the same generic SMO solvers:

- one-class:  min 0.5 a^T K a   s.t. 0 <= a_i <= 1, sum a = nu*l
  (warm-started at the LIBSVM initialization a_i = 1 for i < nu*l).
- epsilon-SVR: the 2l-variable dual with y = [+1]*l ++ [-1]*l,
  p = [eps - z; eps + z] and Q = (y y^T) * tile(K, (2,2)) — exactly SVR_Q.

Decision values f(x) = sum_i coef_i K(x_i, x) - rho in both cases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .solver import smo_solve, smo_solve_nu


@dataclass
class KernelRegressorModel:
    """Shared shape for one-class and SVR models on precomputed kernels."""

    svm_type: str  # "one_class" | "epsilon_svr"
    sv_index: np.ndarray  # training-set indices of SVs
    sv_coef: np.ndarray  # (n_sv,) coefficients
    rho: float

    def decision(self, k_row: np.ndarray) -> float:
        """f(x) from a row of kernel values vs the full training set."""
        return float(self.sv_coef @ np.asarray(k_row)[self.sv_index] - self.rho)


def one_class_train(K: np.ndarray, nu: float, *, eps: float = 1e-3) -> KernelRegressorModel:
    """Schoelkopf one-class SVM (svm.cpp solve_one_class)."""
    l = K.shape[0]
    if not 0 < nu <= 1:
        raise ValueError("nu must be in (0, 1]")
    alpha0 = np.zeros(l)
    n_full = int(nu * l)
    alpha0[:n_full] = 1.0
    if n_full < l:
        alpha0[n_full] = nu * l - n_full
    y = np.ones(l)
    p = np.zeros(l)
    res = smo_solve(K, y, p, 1.0, 1.0, eps=eps, alpha0=alpha0)
    sv = np.flatnonzero(res.alpha > 1e-12)
    return KernelRegressorModel(
        svm_type="one_class", sv_index=sv, sv_coef=res.alpha[sv], rho=res.rho
    )


def svr_train(
    K: np.ndarray, z: np.ndarray, *, C: float = 1.0, p: float = 0.1, eps: float = 1e-3
) -> KernelRegressorModel:
    """epsilon-SVR (svm.cpp solve_epsilon_svr): tube width p, cost C."""
    l = K.shape[0]
    z = np.asarray(z, np.float64)
    K2 = np.tile(K, (2, 2))
    y2 = np.concatenate([np.ones(l), -np.ones(l)])
    p2 = np.concatenate([p - z, p + z])
    res = smo_solve(K2, y2, p2, C, C, eps=eps)
    beta = res.alpha[:l] - res.alpha[l:]
    sv = np.flatnonzero(np.abs(beta) > 1e-12)
    return KernelRegressorModel(
        svm_type="epsilon_svr", sv_index=sv, sv_coef=beta[sv], rho=res.rho
    )


def solve_nu_svc(
    K: np.ndarray, y_pm: np.ndarray, nu: float, *, eps: float = 1e-3
) -> tuple[np.ndarray, float, float]:
    """Binary nu-SVC (svm.cpp solve_nu_svc).

    Returns (signed coefficients y_i*alpha_i scaled by 1/r, rho, 1/r) where
    1/r is the equivalent C-SVC cost: the scaled solution reproduces the
    decision values of C-SVC trained at C = 1/r.
    """
    y_pm = np.asarray(y_pm, np.float64)
    l = len(y_pm)
    n_pos = int(np.sum(y_pm > 0))
    n_neg = l - n_pos
    if not 0 < nu <= 1:
        raise ValueError("nu must be in (0, 1]")
    if nu * l / 2 > min(n_pos, n_neg):
        raise ValueError("specified nu is infeasible")
    # feasible start: each class absorbs nu*l/2 total alpha, capped at 1/ex.
    alpha0 = np.zeros(l)
    for mask in (y_pm > 0, y_pm < 0):
        remain = nu * l / 2.0
        for i in np.flatnonzero(mask):
            alpha0[i] = min(1.0, remain)
            remain -= alpha0[i]
    res, r = smo_solve_nu(K, y_pm, np.zeros(l), 1.0, 1.0, alpha0, eps=eps)
    if r <= 0:
        raise ValueError("nu-SVC degenerate solution (r <= 0)")
    coef = res.alpha * y_pm / r
    return coef, res.rho / r, 1.0 / r


def nu_svr_train(
    K: np.ndarray, z: np.ndarray, *, C: float = 1.0, nu: float = 0.5, eps: float = 1e-3
) -> KernelRegressorModel:
    """nu-SVR (svm.cpp solve_nu_svr): the tube width epsilon is a solver
    output (-r), traded against the fraction nu of tube violations."""
    l = K.shape[0]
    z = np.asarray(z, np.float64)
    if not 0 < nu <= 1:
        raise ValueError("nu must be in (0, 1]")
    K2 = np.tile(K, (2, 2))
    y2 = np.concatenate([np.ones(l), -np.ones(l)])
    p2 = np.concatenate([-z, z])
    alpha0 = np.zeros(2 * l)
    remain = C * nu * l / 2.0
    for i in range(l):
        alpha0[i] = alpha0[i + l] = min(C, remain)
        remain -= alpha0[i]
    res, _r = smo_solve_nu(K2, y2, p2, C, C, alpha0, eps=eps)
    beta = res.alpha[:l] - res.alpha[l:]
    sv = np.flatnonzero(np.abs(beta) > 1e-12)
    return KernelRegressorModel(
        svm_type="nu_svr", sv_index=sv, sv_coef=beta[sv], rho=res.rho
    )


def save_variant_model(path: str, model: KernelRegressorModel) -> None:
    """LIBSVM-compatible model text for one_class / epsilon_svr models."""
    with open(path, "w") as f:
        f.write(f"svm_type {model.svm_type}\n")
        f.write("kernel_type precomputed\n")
        f.write(f"total_sv {len(model.sv_index)}\n")
        f.write(f"rho {model.rho:.17g}\n")
        f.write("SV\n")
        for c, sv in zip(model.sv_coef, model.sv_index):
            f.write(f"{c:.16g} 0:{int(sv) + 1} \n")


def load_variant_model(path: str) -> KernelRegressorModel:
    svm_type = "one_class"
    rho = 0.0
    sv_index: list[int] = []
    sv_coef: list[float] = []
    with open(path) as f:
        lines = iter(f)
        for line in lines:
            line = line.strip()
            if line == "SV":
                break
            key, *rest = line.split()
            if key == "svm_type":
                svm_type = rest[0]
            elif key == "rho":
                rho = float(rest[0])
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            sv_coef.append(float(parts[0]))
            for cell in parts[1:]:
                idx, val = cell.split(":")
                if idx == "0":
                    sv_index.append(int(float(val)) - 1)
    return KernelRegressorModel(
        svm_type=svm_type,
        sv_index=np.asarray(sv_index, np.int64),
        sv_coef=np.asarray(sv_coef),
        rho=rho,
    )
