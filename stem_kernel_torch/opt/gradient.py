"""Smoothed-AUC objective and hypergradients through the SVM solution.

A numpy copy of ``stem_kernel_tpu.opt.gradient``, on the port's SMO.

NumPy equivalent of GradientComputationAUC
(optimizer/gradient.cpp:106-644):

1. train C-SVC (SMO) on the fold's training half;
2. decision values on the held-out half;
3. smoothed AUC: mean sigmoid of positive-negative decision differences,
   slope adapted to the difference variance (s = 10/rho, with the variance
   back-propagated: w = sig*(1-sig)*(s + v*s2*(v-avg)), gradient.cpp:159-206);
4. KKT linear system for the free SVs solved by conjugate gradient
   (solve_d + conjugate_gradient, gradient.cpp:405-509, 622-644);
5. chain rule: df/dC (calculate_gradient_c, :511-547) and df/dtheta_p
   contracted against dK/dtheta_p (calculate_gradient_p, :549-620).
"""

from __future__ import annotations

import numpy as np

from ..svm.solver import smo_solve

SIGMOID_CONST = 10.0


def smoothed_auc_delta(dec_values: np.ndarray, y_ts: np.ndarray) -> tuple[float, np.ndarray]:
    """(smoothed AUC, d AUC / d decision value) for held-out points."""
    pos = np.flatnonzero(y_ts >= 0)
    neg = np.flatnonzero(y_ts < 0)
    if len(pos) == 0 or len(neg) == 0:
        return 0.0, np.zeros_like(dec_values)
    diffs = dec_values[pos][:, None] - dec_values[neg][None, :]  # (P, N)
    d = diffs.ravel()
    avg = d.mean()
    var = max(d.var(), 1e-10)
    rho = np.sqrt(var)
    s = SIGMOID_CONST / rho
    s2 = -SIGMOID_CONST / (d.size * rho * var)
    sig = 1.0 / (1.0 + np.exp(-s * diffs))
    auc = float(sig.mean())
    w = sig * (1.0 - sig) * (s + diffs * s2 * (diffs - avg)) / d.size
    delta = np.zeros_like(dec_values)
    np.add.at(delta, pos, w.sum(axis=1))
    np.add.at(delta, neg, -w.sum(axis=0))
    return auc, delta


def _conjugate_gradient(A: np.ndarray, b: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """CG for symmetric (possibly indefinite-ish) A (gradient.cpp:622-644)."""
    x = np.zeros_like(b)
    r = b - A @ x
    if float(r @ r) < tol:
        return x
    w = -r
    z = A @ w
    a = float(r @ w) / float(w @ z)
    x = x + a * w
    for _ in range(len(b)):
        r = r - a * z
        if float(r @ r) < tol:
            break
        beta = float(r @ z) / float(w @ z)
        w = -r + beta * w
        z = A @ w
        denom = float(w @ z)
        if abs(denom) < 1e-300:
            break
        a = float(r @ w) / denom
        x = x + a * w
    return x


def svm_fold_solution(K, y, tr_i, ts_i, C, eps=1e-3):
    """(alpha, b, decision values) for one fold's SVM."""
    y = np.asarray(y, dtype=np.float64)
    ytr = y[tr_i]
    Ktr = K[np.ix_(tr_i, tr_i)]
    res = smo_solve(Ktr, ytr, -np.ones(len(tr_i)), C, C, eps=eps)
    dec = K[np.ix_(ts_i, tr_i)] @ (res.alpha * ytr) - res.rho
    return res.alpha, res.rho, dec


def auc_gradient_fold(
    K: np.ndarray,
    G: np.ndarray,
    y: np.ndarray,
    tr_i: np.ndarray,
    ts_i: np.ndarray,
    C: float,
    eps: float = 1e-3,
) -> tuple[float, np.ndarray, float]:
    """(f, df/dparams, df/dC) for one CV fold.

    K: (n, n) kernel matrix over ALL examples; G: (P, n, n) dK/dtheta_p;
    y: (n,) labels in {+1, -1}; tr_i/ts_i: fold index sets.
    """
    alpha, b, dec = svm_fold_solution(K, y, tr_i, ts_i, C, eps)
    y = np.asarray(y, dtype=np.float64)
    f, delta = smoothed_auc_delta(dec, y[ts_i])
    fg, cg = decision_hypergradients(K, G, y, tr_i, ts_i, C, alpha, b, delta)
    return f, fg, cg


def decision_hypergradients(K, G, y, tr_i, ts_i, C, alpha, b, delta):
    """(df/dparams, df/dC) given df/ddec = delta (gradient.cpp steps 4-5)."""
    y = np.asarray(y, dtype=np.float64)
    ytr = y[tr_i]
    # partition of training points (find_support_vectors, gradient.cpp:369-403)
    free = (alpha > 0) & (alpha < C)
    clipped = alpha >= C
    u_idx = tr_i[free]  # global indices of free SVs
    c_idx = tr_i[clipped]
    alpha_u = alpha[free]
    nsv = len(u_idx)

    yu = y[u_idx]
    d_u = np.zeros(nsv + 1)
    if nsv > 0:
        P = np.zeros((nsv + 1, nsv + 1))
        P[:nsv, :nsv] = np.outer(yu, yu) * K[np.ix_(u_idx, u_idx)]
        P[:nsv, nsv] = -yu
        P[nsv, :nsv] = -yu
        r = np.zeros(nsv + 1)
        r[:nsv] = (yu[:, None] * K[np.ix_(u_idx, ts_i)]) @ delta
        r[nsv] = -delta.sum()
        d_u = _conjugate_gradient(P, r)

    # df/dC (calculate_gradient_c)
    cg = 0.0
    yc = y[c_idx]
    if nsv > 0:
        q_dot = np.zeros(nsv + 1)
        if len(c_idx):
            q_dot[:nsv] = -(yu[:, None] * yc[None, :] * K[np.ix_(u_idx, c_idx)]).sum(1)
            q_dot[nsv] = yc.sum()
        cg += float(d_u @ q_dot)
    if len(c_idx):
        cg += float(delta @ (K[np.ix_(ts_i, c_idx)] * yc[None, :]).sum(1))

    # df/dtheta_p (calculate_gradient_p)
    n_params = G.shape[0]
    fg = np.zeros(n_params)
    beta_full = np.concatenate([alpha, [b]])
    for p in range(n_params):
        Gp = G[p]
        val = 0.0
        if nsv > 0:
            q_dot = np.zeros(nsv + 1)
            if len(c_idx):
                q_dot[:nsv] = -C * (
                    yu[:, None] * yc[None, :] * Gp[np.ix_(u_idx, c_idx)]
                ).sum(1)
            P_dot_beta = np.zeros(nsv + 1)
            P_dot_beta[:nsv] = (
                np.outer(yu, yu) * Gp[np.ix_(u_idx, u_idx)]
            ) @ alpha_u
            val += float(d_u @ (q_dot - P_dot_beta))
        dpsi = np.zeros(len(tr_i) + 1)
        dpsi[:-1] = (Gp[np.ix_(ts_i, tr_i)] * y[tr_i][None, :]).T @ delta
        val += float(dpsi @ beta_full)
        fg[p] = val
    return fg, cg
