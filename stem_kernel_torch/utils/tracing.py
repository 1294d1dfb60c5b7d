"""The program's spans and counters, and its profiler trace.

Port of ``stem_kernel_tpu/utils/tracing.py``.  The reference's
boost::timer accumulation around kernel evaluations and "elapsed time"
prints (stem_kernel/common/kernel_matrix.cpp:49-52, common/framework.h:139)
become profiler ranges around the program's stages, named
``stem_kernel::<name>`` (:func:`span`), and a process-wide registry of
counters (:func:`count`): launches by route, pairs, batches, host reads.
``device_profile`` wraps ``torch.profiler`` around a block and writes a
Chrome trace (the JAX package writes TensorBoard's format) and the block's
counters beside it.  The memory probe mirrors estimate_memory_size
(stem_kernel/stem_kernel_lite/main.cpp:19-75).

A span is a range only while a profiler records (``--trace-dir``, or any
``torch.profiler.profile`` around the call); otherwise :func:`span` returns
one shared no-op context, at the cost of one check.  The ranges are the
profiler's own events, on the clock of its device events, so a gap on the
device's timeline falls inside the innermost range of the stage the host
was in.  They are function-scope ranges: the profiler puts no copy of them
on the device's timeline, whose events stay the device's own work.  A
counter counts numbers the host holds (shapes, lengths, Python ints) and
never reads a device value.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

try:
    from torch._C._autograd import _profiler_enabled
    from torch._C._profiler import _RecordFunctionFast
except ImportError as e:  # private names of torch's profiler
    raise ImportError(
        f"stem_kernel_torch's spans need torch._C._autograd._profiler_enabled and "
        f"torch._C._profiler._RecordFunctionFast, which torch {torch.__version__} lacks") from e

from ..parallel.distributed import world

TRACE_FILE = "trace.json"
COUNTERS_FILE = "counters.json"
PREFIX = "stem_kernel::"

_NO_SPAN = contextlib.nullcontext()
_counts: dict[str, int] = {}


def span(name: str):
    """A profiler range ``stem_kernel::<name>`` around a block while a
    profiler records; the shared no-op context otherwise."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


def _rank_file(name: str) -> str:
    """``name``, or on rank r > 0 of a process group ``<stem>_rank{r}.json``,
    so ranks that share a directory do not overwrite one file (JAX's
    profiler writes one file per host)."""
    rank, _ = world()
    stem, ext = os.path.splitext(name)
    return name if rank == 0 else f"{stem}_rank{rank}{ext}"


def trace_file() -> str:
    """This process's trace file name: ``trace.json``, or
    ``trace_rank{r}.json`` on rank r > 0."""
    return _rank_file(TRACE_FILE)


def counters_file() -> str:
    """This process's counters file name: ``counters.json``, or
    ``counters_rank{r}.json`` on rank r > 0."""
    return _rank_file(COUNTERS_FILE)


@contextlib.contextmanager
def device_profile(log_dir: str | None, device=None):
    """Trace a block with torch.profiler into ``log_dir/trace.json`` (Chrome
    trace format: the program's ``stem_kernel::`` ranges among the host's
    ops, with the device's kernels when ``device`` is a CUDA device) and
    write what the counters counted in the block to ``log_dir/counters.json``
    (:func:`trace_file`, :func:`counters_file` name them on ranks past 0).
    An empty ``log_dir`` traces nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = counters()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, trace_file()))
        delta = {k: v - before.get(k, 0) for k, v in sorted(_counts.items())
                 if v != before.get(k, 0)}
        with open(os.path.join(log_dir, counters_file()), "w") as f:
            json.dump(delta, f, indent=1)


def dag_memory_probe(dags) -> dict[str, float]:
    """Per-DAG memory estimate + max live node count.

    The array-encoding analogue of Data::used_memory_size / max_node_size
    (stem_kernel/stem_kernel_lite/data.cpp:362-393): bytes for the dense
    node/edge/closure tensors and the max_pa-based live-row bound.
    """
    total_bytes = 0
    max_live = 0
    for d in dags:
        n = d.n_nodes
        total_bytes += (
            d.bp_freq.nbytes + d.weight.nbytes + d.first.nbytes + d.last.nbytes
            + d.edge_to.nbytes + d.edge_gaps.nbytes + d.edge_ptr.nbytes
            + 2 * n * n * 4  # A and V closures
        )
        # live rows under max_pa recycling (max_node_size semantics)
        c = np.zeros(n, dtype=np.int64)
        for i in range(n):
            hi = d.max_pa[i] if d.max_pa[i] >= 0 else i + 1
            c[i: max(int(hi), i + 1)] += 1
        max_live = max(max_live, int(c.max()) if n else 0)
    return {
        "total_bytes": float(total_bytes),
        "mean_bytes": float(total_bytes / max(len(dags), 1)),
        "max_live_nodes": float(max_live),
    }
