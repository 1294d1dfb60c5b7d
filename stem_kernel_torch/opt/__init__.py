"""Hyperparameter optimization: bound-constrained L-BFGS, smoothed-AUC
objective with KKT hypergradients, and classic-kernel optimizers.

Numpy copies of ``stem_kernel_tpu.opt``, their arithmetic unchanged; the
SVM solves run on the port's own ``svm/solver.py``.
"""

from .lbfgsb import LBFGSB, LOWER_BOUND, BOTH_BOUNDS, UPPER_BOUND, UNBOUND
from .gradient import auc_gradient_fold, smoothed_auc_delta
from .optimizer import optimize_kernel_params, cv_split

__all__ = [
    "LBFGSB",
    "LOWER_BOUND",
    "BOTH_BOUNDS",
    "UPPER_BOUND",
    "UNBOUND",
    "auc_gradient_fold",
    "smoothed_auc_delta",
    "optimize_kernel_params",
    "cv_split",
]
