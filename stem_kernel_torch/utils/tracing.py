"""Structured per-stage timing and device profiling.

Port of ``stem_kernel_tpu/utils/tracing.py``.  The reference's
boost::timer accumulation around kernel evaluations and "elapsed time"
prints (stem_kernel/common/kernel_matrix.cpp:49-52, common/framework.h:139)
become a stage-timer registry with items/s throughput, and
``device_profile`` wraps ``torch.profiler`` around a block and writes a
Chrome trace (the JAX package writes TensorBoard's format).  The memory
probe mirrors estimate_memory_size (stem_kernel/stem_kernel_lite/main.cpp:19-75).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.distributed import world

TRACE_FILE = "trace.json"


@dataclass
class StageTimer:
    """Accumulates wall time and item counts per named stage."""

    totals: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += items

    def report(self, out=sys.stderr) -> None:
        for name, total in sorted(self.totals.items()):
            line = f"{name}: {total:.2f}s"
            if self.counts[name]:
                line += f" ({self.counts[name] / max(total, 1e-9):.1f} items/s)"
            print(line, file=out)


def trace_file() -> str:
    """This process's trace file name: ``trace.json``, or on rank r > 0 of a
    process group ``trace_rank{r}.json``, so ranks that share a directory do
    not overwrite one file (JAX's profiler writes one file per host)."""
    rank, _ = world()
    return TRACE_FILE if rank == 0 else f"trace_rank{rank}.json"


@contextlib.contextmanager
def device_profile(log_dir: str | None, device=None):
    """Trace a block with torch.profiler into ``log_dir/trace.json`` (Chrome
    trace format; ``trace_file`` names it on ranks past 0): CPU activity,
    and CUDA activity when ``device`` is a CUDA device.  An empty
    ``log_dir`` traces nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, trace_file()))


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
