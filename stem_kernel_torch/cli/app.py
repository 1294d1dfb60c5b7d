"""Shared application flow: train (Gram build) and predict (test rows).

Port of ``stem_kernel_tpu/cli/app.py`` (the reference's App<Kernel,
LoaderFactory>, stem_kernel/common/framework.h:100-416):

- positional grammar ``output [label file]... [--test [label file]...]``
  (Options::parse_extra_args, framework.cpp:48-139), with glob expansion;
- train: load examples -> Gram matrix -> optional cosine normalization ->
  LIBSVM PRECOMPUTED output (gzip/bzip2 by suffix);
- predict: load the train set, restrict to support vectors of the given
  models, compute test rows + self values in chunks, normalize against train
  diagonals, write matrix rows / norm file, and run SVM prediction per model
  (framework.h:167-306).

A process runs on one device, named explicitly.  Started as several
ranks (``torchrun --nproc-per-node N -m stem_kernel_torch.cli.<cli> ...``),
each rank drives the GPU of its ``LOCAL_RANK``, the Gram's pair batches are
split across the ranks (``--devices``, ``--single-device``; parallel.mesh)
and rank 0 alone writes files.  ``--checkpoint`` resumes the train Gram
unit by unit (gram.checkpoint), ``--trace-dir`` writes a torch.profiler
Chrome trace of the whole flow, its stages as ranges, and the run's counters
(utils.tracing), and ``--use-pf-scale-file`` reads 'label file pf_file'
triples.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from ..gram.engine import PairKernelEngine
from ..gram.io import _open_write, write_norm, write_precomputed, write_rows
from ..io.parsers import expand_globs, iter_alignments
from ..io.profile import Alignment
from ..parallel.distributed import initialize, rank_device
from ..parallel.mesh import process_zero, resolve_mesh
from ..svm.model import load_model, load_sv_index
from ..svm.train import svm_predict_probability, svm_predict_values
from ..utils.tracing import device_profile, span


@dataclass
class AppOptions:
    """Common options (Options, framework.cpp:10-46)."""

    output: str = ""
    labels: list[str] = field(default_factory=list)
    files: list[str] = field(default_factory=list)
    ts_labels: list[str] = field(default_factory=list)
    ts_files: list[str] = field(default_factory=list)
    predict_mode: bool = False
    normalize: bool = False
    norm_output: str = ""
    predict_only: bool = False  # --no-matrix
    model_files: list[str] = field(default_factory=list)
    predict_outputs: list[str] = field(default_factory=list)
    trace_dir: str = ""
    use_pf_scale_file: bool = False
    pf_files: list[str] = field(default_factory=list)
    pf_ts_files: list[str] = field(default_factory=list)
    stream_chunk: int = 64  # test examples featurized per predict chunk
    devices: int = 0  # 0 = every rank; 1 = single-device dispatch on each rank
    checkpoint: str = ""  # train-Gram checkpoint/resume directory


def add_common_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on: 'cuda' (the hand-written kernels; "
                        "fails when no GPU is present) or 'cpu' (the plain "
                        "torch versions)")
    p.add_argument("-n", "--normalize", action="store_true",
                   help="normalize the kernel matrix")
    p.add_argument("-x", "--norm", default="",
                   help="set the filename for norms of test examples")
    p.add_argument("--no-matrix", action="store_true",
                   help="do not output matrix")
    p.add_argument("--model", action="append", default=[],
                   help="the model file trained by svm-train if you already have")
    p.add_argument("--predict", action="append", default=[],
                   help="output file name of prediction results")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for compatibility (parallelism is rank based)")
    p.add_argument("--stream-chunk", type=int, default=64,
                   help="predict mode: featurize this many test examples at a time")
    p.add_argument("--devices", type=int, default=0,
                   help="split the Gram's pair batches over this many ranks, one "
                        "GPU each (0 = every rank; the analogue of the reference's "
                        "mpirun rank count).  Start the ranks with torchrun "
                        "--nproc-per-node N -m stem_kernel_torch.cli.<cli> ...; "
                        "without a launcher one process drives one GPU")
    p.add_argument("--single-device", action="store_true",
                   help="force plain single-device dispatch (same as --devices 1): "
                        "every rank computes the whole Gram, rank 0 writes it")
    p.add_argument("--checkpoint", default="",
                   help="directory for unit-granular train-Gram checkpointing: a "
                        "restarted train run resumes, skipping completed units "
                        "(the reference restarts multi-hour Gram runs from zero)")
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json (Chrome trace format; view it in "
                        "chrome://tracing or Perfetto), the program's stages "
                        "in it as stem_kernel::<stage> ranges, and the run's "
                        "counters (launches by route, Gram pairs and batches, "
                        "host reads) to DIR/counters.json")
    p.add_argument("--use-pf-scale-file", action="store_true",
                   help="positional args come as 'label file pf_scale_file' "
                        "triples (framework.cpp:26-30); the scaled fold "
                        "engine self-normalizes, so the values only validate "
                        "example counts")
    # the positional grammar "output [label file]... [--test ...]" is collected
    # from unrecognized args (labels like -1 confuse argparse), mirroring the
    # reference's collect_unrecognized pattern (stem_kernel_lite/main.cpp:152-163)


def resolve_device(name: str) -> torch.device:
    """The device the CLI runs on, after joining the process group of a
    multi-process launch (parallel.distributed.initialize): under a group,
    'cuda' is the GPU of this rank's ``LOCAL_RANK``.  'cuda' without a GPU
    raises."""
    initialize()
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu to "
            "run the plain torch versions on the CPU)")
    return rank_device(name)


def parse_args_with_positionals(p: argparse.ArgumentParser, argv):
    ns, rest = p.parse_known_args(argv)
    if not rest:
        p.error("missing positional arguments: output [label file] ...")
    ns.args = rest
    return ns


def parse_positional(ns: argparse.Namespace) -> AppOptions:
    """parse_extra_args semantics (framework.cpp:48-139)."""
    extra = ns.args
    opts = AppOptions(
        output=extra[0],
        normalize=ns.normalize,
        norm_output=ns.norm,
        predict_only=ns.no_matrix,
        model_files=list(ns.model),
        predict_outputs=list(ns.predict),
        trace_dir=ns.trace_dir,
        use_pf_scale_file=ns.use_pf_scale_file,
        stream_chunk=ns.stream_chunk,
        devices=1 if ns.single_device else ns.devices,
        checkpoint=ns.checkpoint,
    )
    if "--test" in extra:
        opts.predict_mode = True
        x = extra.index("--test")
        pairs = extra[1:x]
        ts = extra[x + 1:]
    else:
        pairs = extra[1:]
        ts = []
    stride = 3 if opts.use_pf_scale_file else 2
    opts.labels = pairs[0::stride]
    opts.files = pairs[1::stride]
    opts.ts_labels = ts[0::stride]
    opts.ts_files = ts[1::stride]
    if opts.use_pf_scale_file:
        # 'label file pf_scale_file' triples (framework.cpp:96-139;
        # DataLoader pf_is_, stem_kernel_lite/data.cpp:510-538)
        opts.pf_files = pairs[2::stride]
        opts.pf_ts_files = ts[2::stride]
    return opts


def load_pf_scales(pf_files: list[str], counts: list[int]) -> list[float]:
    """Read per-example pf_scale side files (one float per example,
    stem_kernel_lite/data.cpp:510-538).  The fold engine rescales per length
    itself, so the values are only validated against the example counts and
    returned for diagnostics."""
    scales: list[float] = []
    for path, count in zip(pf_files, counts):
        with open(path) as f:
            vals = [float(t) for t in f.read().split()]
        if len(vals) < count:
            raise ValueError(f"{path}: {len(vals)} pf_scale values for {count} examples")
        scales.extend(vals[:count])
    return scales


def load_labeled(labels: list[str], files: list[str], verbose: bool = True,
                 counts_out: list[int] | None = None):
    """Examples per (label, glob) pair, with per-file timing on stderr.

    ``counts_out``: appended with the example count of each (label, pattern)
    argument, to validate pf_scale side files."""
    alignments: list[Alignment] = []
    out_labels: list[str] = []
    for label, pattern in zip(labels, files):
        n_before = len(alignments)
        for path in expand_globs([pattern]):
            t0 = time.time()
            n0 = len(alignments)
            for aln in iter_alignments(path):
                alignments.append(aln)
                out_labels.append(label)
            if verbose:
                print(f"loading {path} as label {label} ({len(alignments)-n0} ex, "
                      f"{time.time()-t0:.1f}s) done.", file=sys.stderr)
        if counts_out is not None:
            counts_out.append(len(alignments) - n_before)
    return alignments, out_labels


# featurize: alignments -> (features dict, aux); make_kernel_fn: aux -> kernel_fn
Featurizer = Callable[[list[Alignment]], tuple[Mapping[str, torch.Tensor], object]]


def run_app(
    opts: AppOptions,
    featurize: Featurizer,
    make_kernel_fn: Callable[[object], Callable],
    *,
    device,
    batch_size: int = 256,
    log_kernel: bool = False,
    featurize_buckets=None,
    merge_aux=None,
    slab_batches: int = 16,
    mesh=None,
) -> None:
    """Execute the train or predict flow on ``device``, inside a profiler
    trace when ``opts.trace_dir`` is set.

    The CLIs are the multi-process programs, as the reference's binaries are
    the MPI entry points (framework.h:418-433): the pair batches are split
    over the ranks of ``resolve_mesh(opts.devices)`` (an explicit ``mesh=``
    overrides it), a rank outside that mesh does nothing, and only rank 0
    writes files (framework.h:135-163).

    ``log_kernel``: the kernel_fn returns log K; normalization happens in log
    space.  ``featurize_buckets``: alignments -> list of (indices, feats, aux)
    shape-buckets; when given, the train Gram is assembled block-wise at
    per-bucket pad shapes (gram.bucketed).  ``merge_aux``: combine train and
    test-chunk featurizer aux (``max`` for iteration bounds) when streaming
    predict chunks; None reuses the train aux.  ``slab_batches``: batches in
    a checkpoint unit of the flat engine's train Gram (the JAX CLIs' slab:
    64 for the fast kernels, 16 otherwise).
    """
    if mesh is None:
        initialize()
        mesh = resolve_mesh(opts.devices)
    if mesh is not None and not mesh.member:
        print(f"rank {mesh.rank}: outside the {mesh.size} ranks of --devices; "
              "nothing to do", file=sys.stderr)
        return
    with device_profile(opts.trace_dir, device):
        _run_app_inner(opts, featurize, make_kernel_fn, device=device,
                       batch_size=batch_size, log_kernel=log_kernel,
                       featurize_buckets=featurize_buckets, merge_aux=merge_aux,
                       slab_batches=slab_batches, mesh=mesh)


def _run_app_inner(opts, featurize, make_kernel_fn, *, device, batch_size, log_kernel,
                   featurize_buckets, merge_aux, slab_batches, mesh) -> None:
    io_rank = process_zero()  # rank-0 I/O (framework.h:135-163)
    t_start = time.time()
    counts: list[int] | None = [] if opts.use_pf_scale_file else None
    with span("read"):
        train_alns, train_labels = load_labeled(opts.labels, opts.files, counts_out=counts)
        if opts.use_pf_scale_file:
            load_pf_scales(opts.pf_files, counts)
    if not opts.predict_mode:
        if featurize_buckets is not None:
            from ..gram.bucketed import bucketed_gram

            with span("featurize"):
                buckets = featurize_buckets(train_alns)
            with span("gram"):
                g = bucketed_gram(buckets, make_kernel_fn,
                                  device=device, normalize=opts.normalize,
                                  batch_size=batch_size, log_values=log_kernel,
                                  checkpoint_path=opts.checkpoint or None, mesh=mesh)
        else:
            with span("featurize"):
                feats, aux = featurize(train_alns)
            with span("gram"):
                eng = PairKernelEngine(make_kernel_fn(aux), feats, device=device,
                                       batch_size=batch_size, slab_batches=slab_batches,
                                       log_values=log_kernel, mesh=mesh)
                g = eng.gram(normalize=opts.normalize,
                             checkpoint_path=opts.checkpoint or None)
        if io_rank:
            with span("write"):
                write_precomputed(opts.output, train_labels, g)
        print(f"elapsed time: {time.time()-t_start:.1f}s", file=sys.stderr)
        return

    # ---- predict mode (streaming: fixed-size test chunks) ----
    sv_index = None
    models = []
    with span("read"):
        if opts.model_files:
            sv_index = load_sv_index(opts.model_files)
            models = [load_model(m) for m in opts.model_files]
        ts_counts: list[int] | None = [] if opts.use_pf_scale_file else None
        test_alns, test_labels = load_labeled(opts.ts_labels, opts.ts_files,
                                              counts_out=ts_counts)
        if opts.use_pf_scale_file:
            load_pf_scales(opts.pf_ts_files, ts_counts)

    with span("featurize"):
        train_feats, aux_tr = featurize(train_alns)
    with span("diagonal"):
        eng = PairKernelEngine(make_kernel_fn(aux_tr), train_feats, device=device,
                               batch_size=batch_size, log_values=log_kernel, mesh=mesh)
        diag = eng.diagonal(sv_index=sv_index)

    chunk = max(1, int(opts.stream_chunk or 64))
    all_norm_rows, all_self = [], []
    # self values feed only normalization and the norm file
    need_self = bool(opts.normalize) or bool(opts.norm_output)
    for lo in range(0, len(test_alns), chunk):
        with span("chunk"):
            with span("featurize"):
                feats_c, aux_c = featurize(test_alns[lo: lo + chunk])
            if merge_aux is not None:
                eng.kernel_fn = make_kernel_fn(merge_aux(aux_tr, aux_c))
            with span("gram"):
                rows, self_vals = eng.rows(feats_c, sv_index=sv_index, with_self=need_self)
        if log_kernel:
            cols = np.arange(rows.shape[1]) if sv_index is None else np.asarray(sv_index)
            norm_rows = np.zeros_like(rows)
            if opts.normalize:
                norm_rows[:, cols] = np.exp(
                    rows[:, cols] - 0.5 * (diag[None, cols] + self_vals[:, None]))
            else:
                norm_rows[:, cols] = np.exp(rows[:, cols].astype(np.float64))
            self_vals = np.exp(self_vals.astype(np.float64))
        else:
            norm_rows = rows.copy()
            if opts.normalize:
                denom = np.sqrt(np.clip(diag, 1e-300, None))[None, :] * np.sqrt(
                    np.clip(self_vals, 1e-300, None))[:, None]
                cols = np.flatnonzero(diag > 0)
                norm_rows[:, cols] = rows[:, cols] / denom[:, cols]
        all_norm_rows.append(norm_rows)
        all_self.append(self_vals)

    norm_rows = (np.concatenate(all_norm_rows) if all_norm_rows
                 else np.zeros((0, len(train_alns)), np.float32))
    self_vals = (np.concatenate(all_self) if all_self else np.zeros((0,), np.float64))

    with span("write"):
        if not opts.predict_only and io_rank:
            with _open_write(opts.output) as f:
                write_rows(f, test_labels, norm_rows)
        if opts.norm_output and io_rank:
            write_norm(opts.norm_output, self_vals)

    outs = opts.predict_outputs or [f"{opts.output}.pred{i}" for i in range(len(models))]
    with span("svm"):
        for model, out_path in zip(models if io_rank else [], outs):
            with open(out_path, "w") as f:
                for t, label in enumerate(test_labels):
                    if model.prob_A is not None:
                        pred, prob = svm_predict_probability(model, norm_rows[t])
                        f.write(f"{label} {pred} {' '.join(f'{p:g}' for p in prob)}\n")
                    else:
                        pred, dec = svm_predict_values(model, norm_rows[t])
                        f.write(f"{label} {dec[0]:g}\n")
    print(f"elapsed time: {time.time()-t_start:.1f}s", file=sys.stderr)
