"""svm-train / svm-predict CLIs for PRECOMPUTED Gram matrices.

Equivalents of LIBSVM's svm-train / svm-predict used in the reference
workflow (`svm-train -t 4 km.dat`, README.rd:28-30), limited to the
precomputed-kernel path this framework produces.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..gram.io import read_precomputed
from ..svm.model import load_model, save_model
from ..svm.train import (
    svm_cross_validation,
    svm_predict_probability,
    svm_predict_values,
    svm_train,
)


def train_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skt-svm-train")
    p.add_argument("-s", type=int, default=0, dest="svm_type",
                   help="svm type: 0 C-SVC, 1 nu-SVC, 2 one-class, "
                        "3 epsilon-SVR, 4 nu-SVR")
    p.add_argument("-c", type=float, default=1.0, dest="C", help="cost parameter C")
    p.add_argument("-n", type=float, default=0.5, dest="nu",
                   help="nu (nu-SVC, one-class, nu-SVR)")
    p.add_argument("-p", type=float, default=0.1, dest="tube",
                   help="epsilon in the SVR loss function")
    p.add_argument("-e", type=float, default=1e-3, dest="eps", help="stopping tolerance")
    p.add_argument("-b", type=int, default=0, dest="probability",
                   help="1: train probability estimates")
    p.add_argument("-v", type=int, default=0, dest="folds",
                   help="n-fold cross validation mode")
    p.add_argument("matrix", help="PRECOMPUTED kernel matrix file")
    p.add_argument("model", nargs="?", help="output model file")
    ns = p.parse_args(argv)
    labels, K = read_precomputed(ns.matrix)
    out = ns.model or (ns.matrix + ".model")
    if ns.svm_type in (2, 3, 4):
        from ..svm.variants import (
            nu_svr_train,
            one_class_train,
            save_variant_model,
            svr_train,
        )

        if ns.svm_type == 2:
            vmodel = one_class_train(K, ns.nu, eps=ns.eps)
        else:
            z = np.array([float(l) for l in labels])
            if ns.svm_type == 3:
                vmodel = svr_train(K, z, C=ns.C, p=ns.tube, eps=ns.eps)
            else:
                vmodel = nu_svr_train(K, z, C=ns.C, nu=ns.nu, eps=ns.eps)
        save_variant_model(out, vmodel)
        print(f"model saved to {out} ({len(vmodel.sv_index)} SVs)")
        return 0
    stype = "nu_svc" if ns.svm_type == 1 else "c_svc"
    if ns.folds > 1:
        preds = svm_cross_validation(K, labels, ns.folds, C=ns.C, eps=ns.eps)
        acc = float(np.mean([a == b for a, b in zip(preds, labels)]))
        print(f"Cross Validation Accuracy = {acc * 100:g}%")
        return 0
    model = svm_train(K, labels, C=ns.C, eps=ns.eps,
                      probability=bool(ns.probability), svm_type=stype, nu=ns.nu)
    save_model(out, model)
    print(f"model saved to {out} ({model.total_sv} SVs)")
    return 0


def predict_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skt-svm-predict")
    p.add_argument("-b", type=int, default=0, dest="probability")
    p.add_argument("test", help="test rows in PRECOMPUTED format (vs training set)")
    p.add_argument("model", help="model file")
    p.add_argument("output", nargs="?", help="prediction output file")
    ns = p.parse_args(argv)
    labels, rows = read_precomputed(ns.test)
    first = open(ns.model).readline().split()
    if len(first) == 2 and first[1] in ("one_class", "epsilon_svr", "nu_svr"):
        from ..svm.variants import load_variant_model

        vmodel = load_variant_model(ns.model)
        lines = []
        for t in range(len(labels)):
            f = vmodel.decision(rows[t])
            if vmodel.svm_type == "one_class":
                lines.append(f"{1 if f > 0 else -1} {f:g}")
            else:
                lines.append(f"{f:g}")
        out_text = "\n".join(lines) + "\n"
        if ns.output:
            open(ns.output, "w").write(out_text)
        else:
            print(out_text, end="")
        return 0
    model = load_model(ns.model)
    lines = []
    correct = 0
    for t, label in enumerate(labels):
        if ns.probability and model.prob_A is not None:
            pred, prob = svm_predict_probability(model, rows[t])
            lines.append(f"{pred} {' '.join(f'{v:g}' for v in prob)}")
        else:
            pred, dec = svm_predict_values(model, rows[t])
            lines.append(f"{pred} {dec[0]:g}")
        correct += pred == label
    out_text = "\n".join(lines) + "\n"
    if ns.output:
        open(ns.output, "w").write(out_text)
    else:
        print(out_text, end="")
    print(f"Accuracy = {correct / max(len(labels), 1) * 100:g}% ({correct}/{len(labels)})")
    return 0


def main(argv=None) -> int:
    """`python -m stem_kernel_torch.cli.svm_tools [train|predict] ...`.

    With no subcommand, defaults to train (back-compat with the bare
    `svm_tools km.dat` usage; console scripts skt-svm-train /
    skt-svm-predict call train_main / predict_main directly)."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        return train_main(argv[1:])
    if argv and argv[0] == "predict":
        return predict_main(argv[1:])
    return train_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
