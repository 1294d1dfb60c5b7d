"""LIBSVM-compatible model file save/load for PRECOMPUTED-kernel C-SVC.

Matches svm_save_model / svm_load_model
(stem_kernel/libsvm/svm.cpp:1201-1369): header lines (svm_type,
kernel_type, nr_class, total_sv, rho, label, probA/probB, nr_sv) followed by
``SV`` records "coef... 0:<train-index-1-based>".  Also provides the
support-vector index extraction the reference uses to restrict prediction to
SV columns (model_parser / load_sv_index,
stem_kernel/libsvm/model.cpp:25-80).
"""

from __future__ import annotations

import numpy as np

from .train import SVCModel


def save_model(path: str, model: SVCModel) -> None:
    with open(path, "w") as f:
        f.write("svm_type c_svc\n")
        f.write("kernel_type precomputed\n")
        f.write(f"nr_class {model.nr_class}\n")
        f.write(f"total_sv {model.total_sv}\n")
        f.write("rho " + " ".join(f"{r:.17g}" for r in model.rho) + "\n")
        f.write("label " + " ".join(model.labels) + "\n")
        if model.prob_A is not None:
            f.write("probA " + " ".join(f"{v:g}" for v in model.prob_A) + "\n")
            f.write("probB " + " ".join(f"{v:g}" for v in model.prob_B) + "\n")
        f.write("nr_sv " + " ".join(str(v) for v in model.n_sv_per_class) + "\n")
        f.write("SV\n")
        for pos, sv in enumerate(model.sv_index):
            coefs = " ".join(f"{model.sv_coef[r, pos]:.16g}" for r in range(model.nr_class - 1))
            f.write(f"{coefs} 0:{int(sv) + 1} \n")


def load_model(path: str) -> SVCModel:
    labels: list[str] = []
    rho = probA = probB = None
    n_sv_per_class = None
    sv_index: list[int] = []
    sv_coef_rows: list[list[float]] = []
    nr_class = 2
    with open(path) as f:
        lines = iter(f)
        for line in lines:
            line = line.strip()
            if line == "SV":
                break
            if not line:
                continue
            key, *rest = line.split()
            if key == "nr_class":
                nr_class = int(rest[0])
            elif key == "rho":
                rho = np.array([float(v) for v in rest])
            elif key == "label":
                labels = rest
            elif key == "probA":
                probA = np.array([float(v) for v in rest])
            elif key == "probB":
                probB = np.array([float(v) for v in rest])
            elif key == "nr_sv":
                n_sv_per_class = np.array([int(v) for v in rest])
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            coefs = [float(v) for v in parts[: nr_class - 1]]
            for cell in parts[nr_class - 1 :]:
                idx, val = cell.split(":")
                if idx == "0":
                    sv_index.append(int(float(val)) - 1)
            sv_coef_rows.append(coefs)
    sv_coef = np.array(sv_coef_rows).T if sv_coef_rows else np.zeros((nr_class - 1, 0))
    return SVCModel(
        labels=labels,
        sv_index=np.array(sv_index, dtype=np.int64),
        sv_coef=sv_coef,
        rho=rho if rho is not None else np.zeros(nr_class * (nr_class - 1) // 2),
        n_sv_per_class=n_sv_per_class if n_sv_per_class is not None else np.array([len(sv_index), 0]),
        prob_A=probA,
        prob_B=probB,
    )


def load_sv_index(paths: list[str]) -> np.ndarray:
    """Union of 0-based SV training indices across model files.

    Mirrors load_sv_index (stem_kernel/libsvm/model.cpp:54-80), wired into
    prediction at stem_kernel/common/framework.cpp:89-92 so that test
    kernel rows are only computed against support vectors.
    """
    idx: set[int] = set()
    for p in paths:
        idx.update(int(i) for i in load_model(p).sv_index)
    return np.array(sorted(idx), dtype=np.int64)
