"""The flows a traffic mix names: how a job's inputs are made, how its CLI
is called and how much work it is.  A job is one in-process call of the
CLI's ``main(argv)``, as a user runs it, on files under the run's temporary
directory.

- ``train``: a fresh corpus a job (``+1 pos.fa -1 neg.fa``); the CLI
  writes the N x N LIBSVM Gram.  Work: N(N+1)/2 Gram pairs.  With the
  mix's ``work_seed``, job ``j``'s sequences are drawn from that seed and
  ``j`` alone, and ``--seed`` draws their order: every seed runs the same
  work (the same DAGs, so the same K1 routes), in another order.
- ``predict``: set-up makes the run's training corpus and a LIBSVM model
  over it (support vectors drawn from the seed, coefficients +-U(lo, hi)
  by label, rho fixed); a job scores fresh test sequences of the same
  family with ``--test``, ``--model`` and ``--predict``; the CLI writes the
  test rows and the decision values.  Work: the test sequences.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# numpy seed streams: [seed, stream, ...]
MODEL_STREAM, JOB_STREAM = 0, 1


@dataclass
class Job:
    index: int
    directory: Path
    corpus: dict  # {"pos": [...], "neg": [...]}: the training sequences
    argv: list
    output: Path
    pairs: int = 0
    rows: int = 0
    test: dict | None = None  # predict: {"pos": [...], "neg": [...]}
    prediction: Path | None = None
    seconds: float = 0.0
    cpu_seconds: float = 0.0  # the process's CPU time over the job, all threads
    error: str | None = None
    records: dict = field(default_factory=dict)  # what the spans and captures saw


def write_fasta(path: Path, seqs: list, prefix: str) -> str:
    path.write_text("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


def cli_argv(config: dict, traffic: dict, device: str) -> list:
    """The CLI's options, as the configuration and the traffic mix state them."""
    argv = list(config.get("flags", []))
    for opts in (config.get("options", {}), traffic.get("extra_options", {})):
        for key, value in opts.items():
            argv += [key, str(value)]
    return argv + ["--device", device]


class TrainFlow:
    def __init__(self, config: dict, traffic: dict, generator, seed: int, device: str,
                 tmp: Path) -> None:
        self.config, self.traffic, self.gen = config, traffic, generator
        self.seed, self.device, self.tmp = seed, device, tmp
        self.base_argv = cli_argv(config, traffic, device)

    def setup(self) -> None:
        pass

    def make_job(self, index: int) -> Job:
        """Job ``index`` (-1: the warm-up job) on a corpus drawn from
        (seed, index), or from (work_seed, index) in the seed's order."""
        order = np.random.default_rng([self.seed, JOB_STREAM, index + 1])
        work = self.traffic.get("work_seed")
        rng = order if work is None else np.random.default_rng([int(work), JOB_STREAM, index + 1])
        corpus = self.gen.make(self.config["corpus"], rng, max(index, 0))
        if work is not None:
            corpus = dict(corpus, **{k: [corpus[k][i] for i in order.permutation(len(corpus[k]))]
                                     for k in ("pos", "neg")})
        d = self.tmp / f"job{index + 1}"
        d.mkdir()
        out = d / "km.dat"
        argv = self.base_argv + [str(out), "+1", write_fasta(d / "pos.fa", corpus["pos"], "p"),
                                 "-1", write_fasta(d / "neg.fa", corpus["neg"], "n")]
        n = len(corpus["pos"]) + len(corpus["neg"])
        return Job(index, d, corpus, argv, out, pairs=n * (n + 1) // 2)


class PredictFlow(TrainFlow):
    def setup(self) -> None:
        """The run's training corpus and its model file."""
        rng = np.random.default_rng([self.seed, MODEL_STREAM])
        self.model_corpus = self.gen.make(self.config["corpus"], rng, None)
        d = self.tmp / "model"
        d.mkdir()
        self.train_files = ["+1", write_fasta(d / "pos.fa", self.model_corpus["pos"], "p"),
                            "-1", write_fasta(d / "neg.fa", self.model_corpus["neg"], "n")]
        n_pos, n_neg = len(self.model_corpus["pos"]), len(self.model_corpus["neg"])
        k = int(self.traffic["support_vectors_per_class"])
        lo, hi = self.traffic["coefficient_range"]
        sv_pos = np.sort(rng.choice(n_pos, k, replace=False))
        sv_neg = n_pos + np.sort(rng.choice(n_neg, k, replace=False))
        self.sv_index = np.concatenate([sv_pos, sv_neg])
        self.sv_coef = np.concatenate([rng.uniform(lo, hi, k), -rng.uniform(lo, hi, k)]).tolist()
        self.rho = float(self.traffic["rho"])
        self.model_path = d / "model.txt"
        lines = ["svm_type c_svc", "kernel_type precomputed", "nr_class 2",
                 f"total_sv {2 * k}", f"rho {self.rho:.17g}", "label 1 -1", f"nr_sv {k} {k}", "SV"]
        lines += [f"{c:.17g} 0:{i + 1} " for c, i in zip(self.sv_coef, self.sv_index)]
        self.model_path.write_text("\n".join(lines) + "\n")

    def make_job(self, index: int) -> Job:
        rng = np.random.default_rng([self.seed, JOB_STREAM, index + 1])
        spec = dict(self.config["corpus"], per_class=self.traffic["test_per_class"])
        test = self.gen.make(spec, rng, max(index, 0), core=self.model_corpus["core"])
        d = self.tmp / f"job{index + 1}"
        d.mkdir()
        out, pred = d / "rows.dat", d / "pred.txt"
        argv = self.base_argv + [
            "--model", str(self.model_path), "--predict", str(pred), str(out),
            *self.train_files, "--test", "+1", write_fasta(d / "pos.fa", test["pos"], "tp"),
            "-1", write_fasta(d / "neg.fa", test["neg"], "tn")]
        return Job(index, d, self.model_corpus, argv, out, test=test, prediction=pred,
                   rows=len(test["pos"]) + len(test["neg"]))


FLOWS = {"train": TrainFlow, "predict": PredictFlow}


def run_job(main, job: Job) -> None:
    """Call the CLI; a job that raises or returns non-zero is a failed job,
    its traceback kept in ``job.error``."""
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        rc = main(job.argv)
        if rc not in (0, None):
            job.error = f"exit code {rc}"
    except Exception:  # a failed job is counted and the run goes on
        job.error = traceback.format_exc()
    job.seconds = time.perf_counter() - t0
    job.cpu_seconds = time.process_time() - c0


def read_libsvm(path: Path) -> tuple[list, np.ndarray]:
    """(labels, values) of a LIBSVM PRECOMPUTED file: row r's cells
    ``j:v`` for j >= 1 go to column j - 1."""
    labels, rows = [], []
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        labels.append(parts[0])
        cells = dict(c.split(":") for c in parts[1:])
        n = max(int(k) for k in cells)
        rows.append([float(cells.get(str(j), "nan")) for j in range(1, n + 1)])
    width = max((len(r) for r in rows), default=0)
    out = np.full((len(rows), width), np.nan)
    for r, row in enumerate(rows):
        out[r, :len(row)] = row
    return labels, out


def read_predictions(path: Path) -> tuple[list, np.ndarray]:
    """(labels, decision values) of a ``--predict`` file."""
    labels, values = [], []
    for line in path.read_text().splitlines():
        parts = line.split()
        if parts:
            labels.append(parts[0])
            values.append(float(parts[1]))
    return labels, np.asarray(values)
