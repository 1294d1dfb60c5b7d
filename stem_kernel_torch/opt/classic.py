"""Classic kernels on feature vectors with analytic parameter gradients.

A numpy copy of ``stem_kernel_tpu.opt.classic``.

Equivalents of optimizer/{rbf,poly,sigmoid}_kernel.cpp for
the standalone kernel optimizers (rbf_optimizer etc.).  Batched over the
whole data set with one einsum each; params follow the reference:

  rbf(gamma):            K = exp(-gamma*||x-y||^2),     dK/dgamma = -||x-y||^2 K
  poly(gamma,coef0,d):   K = (gamma*<x,y>+coef0)^d,     dK/dgamma = d*<x,y>*(...)^(d-1),
                                                        dK/dcoef0 = d*(...)^(d-1)
  sigmoid(gamma,coef0):  K = tanh(gamma*<x,y>+coef0),   dK/dgamma = <x,y>*(1-K^2),
                                                        dK/dcoef0 = (1-K^2)
"""

from __future__ import annotations

import numpy as np


def rbf_kernel_with_grads(X: np.ndarray, params: np.ndarray):
    gamma = float(params[0])
    sq = np.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    d2 = np.maximum(d2, 0.0)
    K = np.exp(-gamma * d2)
    return K, np.stack([-d2 * K])


def poly_kernel_with_grads(X: np.ndarray, params: np.ndarray, degree: int = 3):
    gamma, coef0 = float(params[0]), float(params[1])
    dot = X @ X.T
    base = gamma * dot + coef0
    K = base**degree
    dbase = degree * base ** (degree - 1)
    return K, np.stack([dot * dbase, dbase])


def sigmoid_kernel_with_grads(X: np.ndarray, params: np.ndarray):
    gamma, coef0 = float(params[0]), float(params[1])
    dot = X @ X.T
    K = np.tanh(gamma * dot + coef0)
    sech2 = 1.0 - K * K
    return K, np.stack([dot * sech2, sech2])
