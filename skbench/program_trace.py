"""A traced run of a cell, its window read a second time by the program's
own ranges and counters (``stem_kernel_torch.utils.tracing``).

    python3 skbench/program_trace.py --workload CELL --seed N --seconds S \
        --out OUT.json

From the root of a checkout.  Runs the cell as ``skbench/run.py --trace 1``
does (its result line on standard output, its checks on standard error)
and writes OUT.json: the program's ``stem_kernel::`` ranges in the window
(count, total and self seconds by name; self is the duration less the
part its child ranges cover), the window's device-idle seconds by the
innermost program range at each idle gap's midpoint ("none" outside every
range), the host reads of device values (``aten::_local_scalar_dense``) a
job and by innermost range, the counters' delta over the window, and the
median K6 batch's timeline (``k6.sync`` end, ``k6.setup``, the first
``full_stem_level`` on the device).  On a program without spans or
counters the ranges and counters read empty.  The benchmark's own runs
never run this.

A stopgap, to be deleted: once ``skbench/tracing.Trace`` reduces the
program's ranges itself (``program_spans``, ``program_gaps``) and the
harness snapshots the counters over the traced window, this script and
its test go.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "stem_kernel::"
K6_LEVEL = "full_stem_level"


def ranges_in(ranges: list, w0: int, w1: int) -> list:
    """(start, end, name) of the ranges that meet [w0, w1), clipped to it,
    outermost first where two start together."""
    clipped = ((max(a, w0), min(b, w1), n) for a, b, n in ranges if b > w0 and a < w1)
    return sorted(clipped, key=lambda r: (r[0], -r[1]))


def nest(ranges: list, w0: int, w1: int) -> tuple[dict, np.ndarray, list]:
    """Walk the nested ranges of one thread over [w0, w1).  Returns
    ({name: (count, total ns, self ns)}, the starts of the stretches in
    which the innermost range stays the same, their names)."""
    totals: dict = {}
    starts, names = [], []
    cur = [w0]
    stack: list = []  # [start, end, name, ns its children cover]

    def emit(t: int, name: str) -> None:
        if t > cur[0]:
            starts.append(cur[0])
            names.append(name)
            cur[0] = t

    def close(top: list) -> None:
        emit(top[1], top[2])
        c, tot, own = totals.get(top[2], (0, 0, 0))
        d = top[1] - top[0]
        totals[top[2]] = (c + 1, tot + d, own + d - top[3])
        if stack:
            stack[-1][3] += d

    for a, b, n in ranges_in(ranges, w0, w1):
        while stack and stack[-1][1] <= a:
            close(stack.pop())
        emit(a, stack[-1][2] if stack else "none")
        stack.append([a, b, n, 0])
    while stack:
        close(stack.pop())
    emit(w1, "none")
    return totals, np.asarray(starts, np.int64), names


def innermost(points: np.ndarray, starts: np.ndarray, names: list) -> list:
    """The innermost range's name at each point ("none" outside every range)."""
    if len(starts) == 0:
        return ["none"] * len(points)
    k = np.searchsorted(starts, points, side="right") - 1
    return [names[i] if i >= 0 else "none" for i in k]


def idle_by_range(busy_s: np.ndarray, busy_e: np.ndarray, w0: int, w1: int,
                  starts: np.ndarray, names: list) -> dict:
    """Device-idle seconds of [w0, w1) by the innermost range at each idle
    gap's midpoint; ``busy_s``, ``busy_e`` are the sorted disjoint busy
    intervals."""
    gs = np.concatenate([[w0], busy_e])
    ge = np.concatenate([busy_s, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    out: dict = {}
    for name, g in zip(innermost((gs + ge) // 2, starts, names), (ge - gs) * 1e-9):
        out[name] = out.get(name, 0.0) + float(g)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def k6_timeline(ranges: list, level_starts: np.ndarray, device_starts: np.ndarray) -> dict:
    """Microseconds, median over the K6 batches: the host's wait in
    ``k6.sync``, from its end to ``k6.setup``'s start, ``k6.setup`` itself,
    and from the sync's end to the first device operation and to the first
    ``full_stem_level`` of the batch on the device."""
    syncs = sorted((a, b) for a, b, n in ranges if n == "k6.sync")
    setups = sorted((a, b) for a, b, n in ranges if n == "k6.setup")
    rows = []
    j = 0
    for a, b in syncs:
        while j < len(setups) and setups[j][0] < b:
            j += 1
        if j == len(setups):
            break
        sa, sb = setups[j]
        k = np.searchsorted(level_starts, sa)
        m = np.searchsorted(device_starts, b)
        if k < len(level_starts) and m < len(device_starts):
            rows.append((b - a, sa - b, sb - sa, device_starts[m] - b, level_starts[k] - b))
    if not rows:
        return {}
    med = np.median(np.asarray(rows, np.float64), axis=0) / 1e3
    keys = ("sync_us", "sync_end_to_setup_us", "setup_us", "sync_end_to_first_device_op_us",
            "sync_end_to_first_level_us")
    return {"batches": len(rows), **{k: float(v) for k, v in zip(keys, med)}}


def reduce_program(events, trace_mod) -> dict:
    """The program's view of a traced window, from the profiler's raw events
    (``trace_mod``: skbench.tracing, whose window, job and device rules it
    shares)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    prefix = trace_mod.PREFIX
    window, jobs, syncs, ranges = None, [], [], []
    dev_s, dev_e, level_s = [], [], []
    on_device = 0
    for ev in events:
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if ev.device_type() == cuda:
            if name.startswith(PROGRAM):
                on_device += 1
            elif not name.startswith(prefix):
                dev_s.append(a)
                dev_e.append(b)
                if K6_LEVEL in name:
                    level_s.append(a)
        elif name == prefix + "window":
            window = (a, b)
        elif name == prefix + "job":
            jobs.append((a, b))
        elif name.startswith(PROGRAM):
            ranges.append((a, b, name[len(PROGRAM):]))
        elif name == trace_mod.SYNC_OP:
            syncs.append(a)
    w0, w1 = window
    s = np.clip(np.asarray(dev_s, np.int64), w0, w1)
    e = np.clip(np.asarray(dev_e, np.int64), w0, w1)
    us, ue = trace_mod._union(s, e)
    totals, starts, names = nest(ranges, w0, w1)
    sync_at = np.asarray([t for t in syncs if w0 <= t < w1], np.int64)
    by_range: dict = {}
    for name in innermost(sync_at, starts, names):
        by_range[name] = by_range.get(name, 0) + 1
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": float((ue - us).sum()) * 1e-9,
        "jobs": len(jobs),
        "program_ranges_on_device": on_device,
        "program_spans": {k: {"count": c, "total_s": t * 1e-9, "self_s": own * 1e-9}
                          for k, (c, t, own) in sorted(totals.items(), key=lambda kv: -kv[1][1])},
        "program_gaps": idle_by_range(us, ue, w0, w1, starts, names),
        "syncs_per_job": [int(((sync_at >= a) & (sync_at < b)).sum()) for a, b in sorted(jobs)],
        "syncs_by_range": by_range,
        "k6_timeline": k6_timeline(ranges_in(ranges, w0, w1), np.sort(np.asarray(level_s, np.int64)),
                                   np.sort(np.asarray(dev_s, np.int64))),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skbench/program_trace.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    # the checkout's root heads the search path, in place of this script's directory
    if Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from skbench import run
    from skbench import tracing as trace_mod

    try:
        from stem_kernel_torch.utils import tracing as program
    except ImportError:
        program = None
    counting = hasattr(program, "counters")
    run.T0 = T0
    starts, extra = [], {}
    profiler, reduce_events = trace_mod.profiler, trace_mod.reduce_events

    def profiler_counted():  # the last call starts the window's profiler
        starts.append(program.counters() if counting else {})
        return profiler()

    def reduce_both(prof):
        after = program.counters() if counting else {}
        extra["counters"] = {k: v - starts[-1].get(k, 0) for k, v in sorted(after.items())
                             if v != starts[-1].get(k, 0)}
        events = prof.profiler.kineto_results.events()
        extra.update(reduce_program(events, trace_mod))
        return trace_mod.Trace(events)

    trace_mod.profiler, trace_mod.reduce_events = profiler_counted, reduce_both
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    Path(args.out).write_text(json.dumps(extra, indent=1))
    print("program_trace " + json.dumps({k: extra.get(k) for k in (
        "program_gaps", "counters", "syncs_by_range", "k6_timeline")}), file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
