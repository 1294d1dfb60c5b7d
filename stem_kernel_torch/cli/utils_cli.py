"""Evaluation / data-prep command-line tools (reference utils/ equivalents).

Port of ``stem_kernel_tpu/cli/utils_cli.py`` (host numpy, no device):

    python -m stem_kernel_torch.cli.utils_cli <command> [args]

One module of small mains mirroring the Ruby/C++ scripts:

  roc                   utils/roc.rb       — AUC + acc/sp/sn from 'label dec' lines
  roc-cv                utils/roc_cv.rb    — per-fold ROC aggregation
  roc-p                 utils/roc_p.rb     — ROC from svm-predict -b probability output
  normalize-matrix      utils/normalize_matrix.rb
  normalize-test-matrix utils/normalize_test_matrix.rb
  radial-basis-matrix   utils/radial_basis_matrix.rb
  submatrix             utils/submatrix.rb — row/column subsetting
  submatrix-test        utils/submatrix_test.rb — column-limited test rows
  dishuffle             utils/dishuffle_fa.rb — dinucleotide-shuffled negatives
  dishuffle-aln         utils/dishuffle_aln.rb — consensus column shuffle (CLUSTAL)
  dishuffle-fa-pos      utils/dishuffle_fa_pos.rb — embed seqs in shuffled flanks
  fa-sampling           utils/fa_sampling.rb — FASTA subsampling
  mean-id               utils/mean_id.cpp  — mean pairwise identity
                        (p_norm inverse-normal of utils/normal.rb lives here too)
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from ..gram.io import read_precomputed, write_precomputed
from ..io.parsers import parse_fasta
from ..utils.roc import acc_sp_sn, roc_curve_and_auc
from ..utils.shuffle import dinucleotide_shuffle
from ..utils.transforms import normalize_matrix, normalize_test_matrix, rbf_from_gram


def _read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


@contextlib.contextmanager
def _output(argv, i: int):
    """argv[i] opened for writing, or standard output when it is absent."""
    if len(argv) > i:
        with open(argv[i], "w") as f:
            yield f
    else:
        yield sys.stdout


def _read_label_dec(stream) -> tuple[np.ndarray, np.ndarray]:
    labels, decs = [], []
    for line in stream:
        parts = line.split()
        if len(parts) >= 2:
            labels.append(int(parts[0]))
            decs.append(float(parts[1]))
    return np.asarray(labels), np.asarray(decs)


def roc_main(argv=None) -> int:
    labels, decs = _read_label_dec(
        sys.stdin if argv is None else _read_text(argv[0]).splitlines())
    auc, _ = roc_curve_and_auc(labels, decs)
    acc, sp, sn = acc_sp_sn(labels, decs)
    print(f"acc={acc * 100}, sp={sp * 100}, sn={sn * 100}")
    print(f"ROC score = {auc}")
    return 0


def roc_cv_main(argv=None) -> int:
    """Aggregate '== <fold> <label> <dec>' lines (roc_cv.rb:7-30)."""
    import re

    folds: dict[int, list[tuple[int, float]]] = {}
    stream = sys.stdin if argv is None else _read_text(argv[0]).splitlines(keepends=True)
    for line in stream:
        m = re.match(r"^== (\d+) ([+-]?\d+) ([+-]?[\d.eE+-]+)", line)
        if m:
            folds.setdefault(int(m.group(1)), []).append(
                (int(m.group(2)), float(m.group(3)))
            )
        elif line.startswith("Cross"):
            print(line, end="")
    s = s2 = num = 0.0
    for f in folds.values():
        labels = np.array([x[0] for x in f])
        decs = np.array([x[1] for x in f])
        auc, _ = roc_curve_and_auc(labels, decs)
        s += auc * len(f)
        s2 += auc * auc * len(f)
        num += len(f)
    avg = s / max(num, 1)
    var = max(s2 / max(num, 1) - avg * avg, 0.0)
    print(f"ROC score = {avg}, {np.sqrt(var)}")
    return 0


def roc_p_main(argv) -> int:
    """args: answer-file [pred-file] — ROC from svm-predict -b output.

    utils/roc_p.rb: the answer file holds one true label per line; the
    prediction stream starts with a 'labels <l1> <l2> ...' header, then
    '<pred> <p(l1)> <p(l2)> ...' rows.  acc/sp/sn come from the predicted
    labels; the ROC score from the positive-class (+1) probability column.
    """
    ans = np.array([int(l.split()[0]) for l in _read_text(argv[0]).splitlines() if l.split()])
    lines = (_read_text(argv[1]) if len(argv) > 1 else sys.stdin.read()).splitlines()
    header = lines[0].split() if lines else []
    order = [int(x) for x in (header[1:] if header and header[0] == "labels" else header)]
    pos = order.index(1)
    preds, probs = [], []
    for line in lines[1:]:
        parts = line.split()
        if not parts:
            continue
        preds.append(int(float(parts[0])))
        probs.append(float(parts[1 + pos]))
    preds, probs = np.asarray(preds), np.asarray(probs)
    if len(ans) != len(preds):
        raise SystemExit("answer/prediction length mismatch")
    tp = int(np.sum((preds == ans) & (ans >= 0)))
    tn = int(np.sum((preds == ans) & (ans < 0)))
    fn = int(np.sum((preds != ans) & (ans >= 0)))
    fp = int(np.sum((preds != ans) & (ans < 0)))
    n = len(ans)
    auc, _ = roc_curve_and_auc(ans, probs)
    acc = (tp + tn) / n
    sp = tn / max(tn + fp, 1)
    sn = tp / max(tp + fn, 1)
    print(f"acc={acc * 100}, sp={sp * 100}, sn={sn * 100}")
    print(f"ROC score = {auc}")
    return 0


def normalize_matrix_main(argv) -> int:
    labels, g = read_precomputed(argv[0])
    out = argv[1] if len(argv) > 1 else "/dev/stdout"
    write_precomputed(out, labels, normalize_matrix(g))
    return 0


def normalize_test_matrix_main(argv) -> int:
    """args: train-matrix norm-file test-matrix [out]."""
    _, g = read_precomputed(argv[0])
    train_diag = np.diag(g)
    self_vals = np.array([float(l) for l in _read_text(argv[1]).splitlines()])
    ts_labels, rows = read_precomputed(argv[2])
    out = argv[3] if len(argv) > 3 else "/dev/stdout"
    write_precomputed(out, ts_labels, normalize_test_matrix(rows, self_vals, train_diag))
    return 0


def radial_basis_matrix_main(argv) -> int:
    """args: gamma matrix [out]."""
    gamma = float(argv[0])
    labels, g = read_precomputed(argv[1])
    out = argv[2] if len(argv) > 2 else "/dev/stdout"
    write_precomputed(out, labels, rbf_from_gram(g, gamma))
    return 0


def submatrix_main(argv) -> int:
    """args: n matrix [out] — keep the first n rows/columns (submatrix.rb)."""
    n = int(argv[0])
    labels, g = read_precomputed(argv[1])
    out = argv[2] if len(argv) > 2 else "/dev/stdout"
    write_precomputed(out, labels[:n], g[:n, :n])
    return 0


def submatrix_test_main(argv) -> int:
    """args: lim matrix [out] — drop columns with index > lim, keep all rows
    (utils/submatrix_test.rb: test rows restricted to the first lim train
    columns)."""
    lim = int(argv[0])
    labels, g = read_precomputed(argv[1])
    out = argv[2] if len(argv) > 2 else "/dev/stdout"
    write_precomputed(out, labels, g[:, :lim])
    return 0


def _norm_tail(z: float) -> float:
    """Φ(z) - 0.5 by the power series of utils/normal.rb (norm_dist)."""
    import math

    z2 = z * z
    t = q = z * math.exp(-0.5 * z2) / math.sqrt(2 * math.pi)
    for i in range(3, 200, 2):
        prev = q
        t *= z2 / i
        q += t
        if q == prev:
            return q
    return 0.5 if z > 0 else -0.5


def p_norm(y: float) -> float:
    """Inverse of _norm_tail via Newton iteration (utils/normal.rb p_norm)."""
    import math

    x = 0.0
    for _ in range(30):
        f = _norm_tail(x)
        df = math.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
        nxt = (y - f) / df + x
        if abs(nxt - x) < 1e-11:
            return nxt
        x = nxt
    return x


def dishuffle_aln_main(argv) -> int:
    """args: in.aln [out.aln] [seed] — consensus-driven column shuffle.

    utils/dishuffle_aln.rb: per column take the majority symbol (or the top-2
    symbols joined if no majority > 50%), dinucleotide-shuffle that consensus
    token string, and emit the alignment's columns in the shuffled order as
    CLUSTAL blocks of 50.
    """
    from ..io.parsers import parse_clustal
    from ..utils.shuffle import dinucleotide_shuffle_indices

    rng = np.random.default_rng(int(argv[2]) if len(argv) > 2 else None)
    aln = parse_clustal(_read_text(argv[0]))[0]  # rows already concatenated
    names = [n for n, _ in aln]
    cols = list(zip(*[s for _, s in aln]))
    th = len(names) * 0.5
    consensus = []
    for col in cols:
        hist: dict[str, int] = {}
        for ch in col:
            hist[ch] = hist.get(ch, 0) + 1
        ranked = sorted(hist, key=lambda k: -hist[k])
        consensus.append(ranked[0] if hist[ranked[0]] > th else "".join(ranked[:2]))

    _, idx = dinucleotide_shuffle_indices(consensus, rng)
    with _output(argv, 1) as out:
        out.write("CLUSTAL W (1.83) multiple sequence alignment\n\n")
        for start in range(0, len(idx), 50):
            chunk = idx[start : start + 50]
            out.write("\n")
            for j, n in enumerate(names):
                out.write(n.ljust(25) + "".join(cols[i][j] for i in chunk) + "\n")
            out.write("\n")
    return 0


def dishuffle_fa_pos_main(argv) -> int:
    """args: in.fa [out.fa] [seed] — embed each sequence in shuffled flanks.

    utils/dishuffle_fa_pos.rb: upstream/downstream lengths drawn via the
    inverse-normal p_norm(rand - 0.5) * (0.05 L) + 0.25 L, clamped to
    [0, 0.5 L]; flanks are dinucleotide shuffles of the sequence.
    """
    rng = np.random.default_rng(int(argv[2]) if len(argv) > 2 else None)
    recs = parse_fasta(_read_text(argv[0]))

    def rand_len(l: int) -> int:
        x = p_norm(float(rng.random()) - 0.5) * (l * 0.05) + l * 0.25
        return int(min(max(x, 0.0), l * 0.5))

    with _output(argv, 1) as out:
        for name, seq in recs:
            up = dinucleotide_shuffle(seq, rng)
            down = dinucleotide_shuffle(seq, rng)
            ul, dl = rand_len(len(seq)), rand_len(len(seq))
            emb = (up[len(up) // 2 : len(up) // 2 + ul] + seq
                   + down[len(down) // 2 : len(down) // 2 + dl])
            out.write(
                f">{name} (orig {len(seq)}, upstream {ul}, downstream {dl}, "
                f"total {ul + dl + len(seq)})\n{emb}\n"
            )
    return 0


def dishuffle_main(argv) -> int:
    """args: in.fa [out.fa] [seed] — dinucleotide-shuffled copies."""
    rng = np.random.default_rng(int(argv[2]) if len(argv) > 2 else None)
    recs = parse_fasta(_read_text(argv[0]))
    with _output(argv, 1) as out:
        for name, seq in recs:
            out.write(f">{name}_shuffled\n{dinucleotide_shuffle(seq, rng)}\n")
    return 0


def fa_sampling_main(argv) -> int:
    """args: n in.fa [out.fa] [seed] — sample n records without replacement."""
    n = int(argv[0])
    rng = np.random.default_rng(int(argv[3]) if len(argv) > 3 else None)
    recs = parse_fasta(_read_text(argv[1]))
    idx = rng.choice(len(recs), size=min(n, len(recs)), replace=False)
    with _output(argv, 2) as out:
        for i in sorted(idx):
            name, seq = recs[i]
            out.write(f">{name}\n{seq}\n")
    return 0


def mean_id_main(argv) -> int:
    """Mean pairwise %identity via the match-count DP (mean_id.cpp:9-33)."""
    recs = parse_fasta(_read_text(argv[0]))
    seqs = [s for _, s in recs]
    print(f"load {len(seqs)} seqs")

    def dp_match(x: str, y: str) -> int:
        n, m = len(x), len(y)
        prev = np.zeros(m + 1, dtype=np.int64)
        for i in range(1, n + 1):
            cur = np.zeros(m + 1, dtype=np.int64)
            for j in range(1, m + 1):
                d = prev[j - 1] + (1 if x[i - 1] == y[j - 1] else -1)
                cur[j] = max(d, prev[j], cur[j - 1])
            prev = cur
        return int(prev[m])

    total = cnt = 0.0
    for i in range(len(seqs)):
        for j in range(i + 1, len(seqs)):
            ident = dp_match(seqs[i], seqs[j]) / min(len(seqs[i]), len(seqs[j]))
            total += ident
            cnt += 1
    print(f"mean identity: {total / max(cnt, 1)}")
    return 0


_COMMANDS = {
    "roc": roc_main,
    "roc-cv": roc_cv_main,
    "roc-p": roc_p_main,
    "submatrix-test": submatrix_test_main,
    "dishuffle-aln": dishuffle_aln_main,
    "dishuffle-fa-pos": dishuffle_fa_pos_main,
    "normalize-matrix": normalize_matrix_main,
    "normalize-test-matrix": normalize_test_matrix_main,
    "radial-basis-matrix": radial_basis_matrix_main,
    "submatrix": submatrix_main,
    "dishuffle": dishuffle_main,
    "fa-sampling": fa_sampling_main,
    "mean-id": mean_id_main,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in _COMMANDS:
        print("commands: " + " ".join(_COMMANDS), file=sys.stderr)
        return 1
    try:
        return _COMMANDS[argv[0]](argv[1:])
    except (IndexError, ValueError) as e:
        doc = (_COMMANDS[argv[0]].__doc__ or "").strip().splitlines()
        usage = doc[0] if doc else ""
        print(f"{argv[0]}: bad arguments ({e})\nusage: {argv[0]} {usage}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"{argv[0]}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
