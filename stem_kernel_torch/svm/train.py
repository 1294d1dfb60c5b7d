"""C-SVC training / prediction on precomputed kernels.

Equivalent of the reference's modified LIBSVM stack
(stem_kernel/libsvm/svm.cpp): per-class grouping and one-vs-one binary
problems (svm_group_classes / svm_train, svm.cpp:580-770), Platt probability
calibration (sigmoid_train, svm.cpp:303-470, following Lin-Weng-Keerthi 2007),
stratification-free n-fold cross-validation (svm_cross_validation,
svm.cpp:908-990), and decision-value / probability prediction
(svm_predict_values / svm_predict_probability, svm.cpp:1053-1199).

Everything operates on a precomputed Gram matrix (kernel_type PRECOMPUTED,
svm.h:22) — kernel columns are just matrix columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .solver import smo_solve


@dataclass
class SVCModel:
    """A trained C-SVC model over precomputed kernels.

    ``sv_index`` holds 0-based indices into the training set (the PRECOMPUTED
    analogue of stored SVs); ``sv_coef`` has shape (nr_class-1, total_sv) as
    in LIBSVM's one-vs-one layout.
    """

    labels: list[str]
    sv_index: np.ndarray
    sv_coef: np.ndarray
    rho: np.ndarray
    n_sv_per_class: np.ndarray
    prob_A: np.ndarray | None = None
    prob_B: np.ndarray | None = None

    @property
    def nr_class(self) -> int:
        return len(self.labels)

    @property
    def total_sv(self) -> int:
        return len(self.sv_index)


def _group_classes(labels: list[str]) -> tuple[list[str], np.ndarray, list[np.ndarray]]:
    """Group examples by label in order of first appearance (svm.cpp:580-640)."""
    uniq: list[str] = []
    for l in labels:
        if l not in uniq:
            uniq.append(l)
    y_idx = np.array([uniq.index(l) for l in labels])
    groups = [np.flatnonzero(y_idx == c) for c in range(len(uniq))]
    return uniq, y_idx, groups


def _train_binary(K, y_pm, C_p, C_n, eps):
    res = smo_solve(K, y_pm, -np.ones(len(y_pm)), C_p, C_n, eps=eps)
    return res.alpha * y_pm, res.rho


def sigmoid_train(dec: np.ndarray, y_pm: np.ndarray, max_iter: int = 100) -> tuple[float, float]:
    """Platt scaling by regularized maximum likelihood (svm.cpp sigmoid_train).

    Newton's method with backtracking from Lin, Weng & Keerthi (2007),
    "A note on Platt's probabilistic outputs for support vector machines".
    Returns (A, B) with P(y=1|f) = 1/(1+exp(A f + B)).
    """
    prior1 = float(np.sum(y_pm > 0))
    prior0 = float(len(y_pm) - prior1)
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y_pm > 0, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    sigma = 1e-12
    eps = 1e-5

    def fval(A, B):
        fApB = dec * A + B
        return float(
            np.sum(
                np.where(
                    fApB >= 0,
                    t * fApB + np.log1p(np.exp(-fApB)),
                    (t - 1) * fApB + np.log1p(np.exp(fApB)),
                )
            )
        )

    fv = fval(A, B)
    for _ in range(max_iter):
        fApB = dec * A + B
        p = np.where(fApB >= 0, np.exp(-fApB) / (1 + np.exp(-fApB)), 1 / (1 + np.exp(fApB)))
        q = 1 - p
        d1 = t - p
        d2 = p * q
        g1 = float(np.sum(dec * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < eps and abs(g2) < eps:
            break
        h11 = float(np.sum(dec * dec * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(dec * d2))
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            nA, nB = A + step * dA, B + step * dB
            nf = fval(nA, nB)
            if nf < fv + 1e-4 * step * gd:
                A, B, fv = nA, nB, nf
                break
            step /= 2.0
        else:
            break
    return A, B


def svm_train(
    K: np.ndarray,
    labels: list[str],
    *,
    C: float = 1.0,
    eps: float = 1e-3,
    probability: bool = False,
    weight: dict[str, float] | None = None,
    svm_type: str = "c_svc",
    nu: float = 0.5,
) -> SVCModel:
    """Train one-vs-one C-SVC (or nu-SVC with ``svm_type='nu_svc'``) on a
    precomputed Gram matrix (svm.cpp:671-906; nu path solve_nu_svc)."""
    uniq, y_idx, groups = _group_classes(labels)
    k = len(uniq)
    n = len(labels)
    weight = weight or {}

    coef_all = np.zeros((k, k, n))  # coef_all[ci, cj, example]
    rho_list, probA, probB = [], [], []
    pair_order = [(i, j) for i in range(k) for j in range(i + 1, k)]
    for ci, cj in pair_order:
        sub = np.concatenate([groups[ci], groups[cj]])
        y_pm = np.where(np.isin(sub, groups[ci]), 1.0, -1.0)
        Ks = K[np.ix_(sub, sub)]
        C_p = C * weight.get(uniq[ci], 1.0)
        C_n = C * weight.get(uniq[cj], 1.0)
        if svm_type == "nu_svc":
            from .variants import solve_nu_svc

            coef, rho, _c_equiv = solve_nu_svc(Ks, y_pm, nu, eps=eps)
        else:
            coef, rho = _train_binary(Ks, y_pm, C_p, C_n, eps)
        coef_all[ci, cj, sub] = coef
        rho_list.append(rho)
        if probability:
            A, B = _binary_probability(Ks, y_pm, C_p, C_n, eps)
            probA.append(A)
            probB.append(B)

    nz = np.flatnonzero(np.abs(coef_all).sum(axis=(0, 1)) > 0)
    # order SVs by class group, as LIBSVM does
    sv_index = np.concatenate([np.intersect1d(g, nz) for g in groups]).astype(np.int64)
    # sv_coef rows: LIBSVM packs k-1 coefficient rows; row r of SV s in class c
    # holds the coefficient of s in the (c, other) problems.  Reconstruct the
    # standard layout: for each class c, its SVs' coefficients in each pair.
    sv_coef = np.zeros((k - 1, len(sv_index)))
    class_of = np.empty(n, dtype=np.int64)
    for c, g in enumerate(groups):
        class_of[g] = c
    for s_pos, s in enumerate(sv_index):
        c = class_of[s]
        r = 0
        for other in range(k):
            if other == c:
                continue
            ci, cj = (c, other) if c < other else (other, c)
            sv_coef[r, s_pos] = coef_all[ci, cj, s]
            r += 1
    n_sv_per_class = np.array([len(np.intersect1d(g, nz)) for g in groups])
    return SVCModel(
        labels=uniq,
        sv_index=sv_index,
        sv_coef=sv_coef,
        rho=np.array(rho_list),
        n_sv_per_class=n_sv_per_class,
        prob_A=np.array(probA) if probability else None,
        prob_B=np.array(probB) if probability else None,
    )


def _binary_probability(Ks, y_pm, C_p, C_n, eps, n_folds: int = 5, seed: int = 0):
    """Out-of-fold decision values -> Platt fit (svm_binary_svc_probability)."""
    n = len(y_pm)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    dec = np.zeros(n)
    for f in range(n_folds):
        test = perm[f::n_folds]
        train = np.setdiff1d(perm, test)
        if len(np.unique(y_pm[train])) < 2:
            dec[test] = 0.0
            continue
        coef, rho = _train_binary(Ks[np.ix_(train, train)], y_pm[train], C_p, C_n, eps)
        dec[test] = Ks[np.ix_(test, train)] @ coef - rho
    return sigmoid_train(dec, y_pm)


def svm_predict_values(model: SVCModel, k_row: np.ndarray) -> tuple[str, np.ndarray]:
    """Predict from one row of kernel values vs the training set.

    Returns (predicted label, pairwise decision values in (ci, cj) order).
    Mirrors svm_predict_values + one-vs-one voting (svm.cpp:1053-1120).
    """
    k = model.nr_class
    sv_k = k_row[model.sv_index]
    starts = np.concatenate([[0], np.cumsum(model.n_sv_per_class)])
    dec = []
    votes = np.zeros(k, dtype=np.int64)
    pair = 0
    for ci in range(k):
        for cj in range(ci + 1, k):
            si, ei = starts[ci], starts[ci + 1]
            sj, ej = starts[cj], starts[cj + 1]
            # coefficient row index: for class ci the row for opponent cj is
            # cj-1 (opponents ordered skipping self); for cj it is ci.
            coef_i = model.sv_coef[cj - 1, si:ei]
            coef_j = model.sv_coef[ci, sj:ej]
            d = float(sv_k[si:ei] @ coef_i + sv_k[sj:ej] @ coef_j - model.rho[pair])
            dec.append(d)
            votes[ci if d > 0 else cj] += 1
            pair += 1
    return model.labels[int(np.argmax(votes))], np.asarray(dec)


def svm_predict_probability(model: SVCModel, k_row: np.ndarray) -> tuple[str, np.ndarray]:
    """Pairwise-coupled class probabilities (svm.cpp:1123-1199)."""
    if model.prob_A is None:
        raise ValueError("model trained without probability=True")
    _, dec = svm_predict_values(model, k_row)
    k = model.nr_class
    pairwise = np.zeros((k, k))
    pair = 0
    for ci in range(k):
        for cj in range(ci + 1, k):
            fApB = dec[pair] * model.prob_A[pair] + model.prob_B[pair]
            p = 1.0 / (1.0 + np.exp(fApB)) if fApB < 0 else np.exp(-fApB) / (1.0 + np.exp(-fApB))
            p = min(max(p, 1e-7), 1 - 1e-7)
            pairwise[ci, cj] = p
            pairwise[cj, ci] = 1 - p
            pair += 1
    prob = _multiclass_probability(pairwise)
    return model.labels[int(np.argmax(prob))], prob


def _multiclass_probability(r: np.ndarray, max_iter: int = 100) -> np.ndarray:
    """Wu-Lin-Weng pairwise coupling (svm.cpp multiclass_probability)."""
    k = r.shape[0]
    if k == 2:
        return np.array([r[0, 1], r[1, 0]])
    p = np.full(k, 1.0 / k)
    Q = np.zeros((k, k))
    for t in range(k):
        Q[t, t] = np.sum(r[:, t][np.arange(k) != t] ** 2)
        for j in range(k):
            if j != t:
                Q[t, j] = -r[j, t] * r[t, j]
    for _ in range(max_iter):
        Qp = Q @ p
        pQp = float(p @ Qp)
        max_err = np.max(np.abs(Qp - pQp))
        if max_err < 0.005 / k:
            break
        for t in range(k):
            diff = (-Qp[t] + pQp) / Q[t, t]
            p[t] += diff
            pQp = (pQp + diff * (diff * Q[t, t] + 2 * Qp[t])) / (1 + diff) ** 2
            Qp = (Qp + diff * Q[:, t]) / (1 + diff)
            p /= 1 + diff
    return p


def svm_cross_validation(
    K: np.ndarray,
    labels: list[str],
    n_folds: int,
    *,
    C: float = 1.0,
    eps: float = 1e-3,
    seed: int = 0,
) -> list[str]:
    """n-fold CV predictions (svm_cross_validation, svm.cpp:908-990).

    Folds are stratified by class, as in the reference: LIBSVM shuffles each
    class independently and deals its points evenly across the folds so every
    fold preserves the class balance (stem_kernel/libsvm/svm.cpp:916-958).
    """
    n = len(labels)
    rng = np.random.default_rng(seed)
    fold_of = np.empty(n, dtype=np.int64)
    next_fold = 0  # continue dealing across classes so small classes spread out
    for cls in dict.fromkeys(labels):  # first-appearance class order, like libsvm
        idx = np.flatnonzero(np.asarray(labels, dtype=object) == cls)
        idx = rng.permutation(idx)
        for i in idx:
            fold_of[i] = next_fold % n_folds
            next_fold += 1
    preds = [""] * n
    for f in range(n_folds):
        test = np.flatnonzero(fold_of == f)
        train = np.setdiff1d(np.arange(n), test)
        model = svm_train(K[np.ix_(train, train)], [labels[i] for i in train], C=C, eps=eps)
        for t in test:
            # kernel row of test point vs the training subset
            row = K[t, train]
            pred, _ = svm_predict_values(model, row)
            preds[t] = pred
    return preds
