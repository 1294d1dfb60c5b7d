"""The traced run: benchmark-side spans around the program's layers, the
profiler over the window, and the reduction of its events.

Spans are ``torch.profiler.record_function`` ranges named ``skbench::<name>``
that the harness wraps around functions of the program it looks up by
name; a name that is gone fails the run.  ``featurize`` and ``fold`` end
with a ``synchronize``, so their spans hold their device work.  The
profiler keeps its events in memory (no Chrome trace is written), and
:func:`reduce_events` turns them into a :class:`Trace`.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import numpy as np
import torch

PREFIX = "skbench::"
# (module, attribute, span, synchronize after): outermost first, so that a
# gap is named by the innermost span around it (``Trace.gaps_by_span``)
SPANS = (
    ("stem_kernel_torch.cli.app", "load_labeled", "read", False),
    ("stem_kernel_torch.cli.stem_kernel_lite", "featurize_stem_bucketed", "featurize", True),
    ("stem_kernel_torch.cli.stem_kernel_lite", "featurize_stem_examples", "featurize", True),
    ("stem_kernel_torch.cli.stem_kernel", "pair_weights", "featurize", False),
    ("stem_kernel_torch.models.composite", "fold_sequences", "fold", True),
    ("stem_kernel_torch.gram.engine", "PairKernelEngine.run_pairs", "gram", False),
    ("stem_kernel_torch.cli.app", "write_precomputed", "write", False),
    ("stem_kernel_torch.cli.app", "write_rows", "write", False),
)
SPAN_ORDER = ("job", "read", "featurize", "gram", "write", "fold")
SYNC_OP = "aten::_local_scalar_dense"  # a host read of a device value


def _lookup(module: str, attr: str):
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    if not hasattr(owner, name):
        raise RuntimeError(f"traced run: {module}.{attr} is gone; the span "
                           f"'{name}' has nothing to wrap")
    return owner, name


def _stem_records(out, records: dict) -> None:
    """Unpadded DAG node counts and depths of the examples a stem
    featurizer returned, by example index: the work K1's roofline counts."""
    buckets = out if isinstance(out, list) else [(None, out[0], None)]
    for idx, feats, _ in buckets:
        nodes = feats["valid"].sum(1).round().to(torch.int64).cpu().numpy()
        depth = feats["depth"].to(torch.int64).cpu().numpy()
        idx = np.arange(len(nodes)) if idx is None else np.asarray(idx)
        records.setdefault("stem_features", []).append((idx, nodes, depth))


@contextlib.contextmanager
def spans(device: torch.device, records_of):
    """Install the span wrappers for the time of the block.  ``records_of()``
    gives the dict of the job that is running, where the stem featurizers'
    node counts go."""
    sync = device.type == "cuda"
    undo = []
    try:
        for module, attr, span, wait in SPANS:
            owner, name = _lookup(module, attr)
            fn = getattr(owner, name)

            def wrapped(*args, _fn=fn, _span=span, _wait=wait, _name=name, **kwargs):
                with torch.profiler.record_function(PREFIX + _span):
                    out = _fn(*args, **kwargs)
                    if _wait and sync:
                        torch.cuda.synchronize(device)
                if _name.startswith("featurize_stem"):
                    _stem_records(out, records_of())
                return out

            functools.update_wrapper(wrapped, fn)
            setattr(owner, name, wrapped)
            undo.append((owner, name, fn))
        yield
    finally:
        for owner, name, fn in reversed(undo):
            setattr(owner, name, fn)


def profiler():
    """A profiler of host ops and device activity, events kept in memory."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(event, end: bool) -> int:
    if hasattr(event, "start_ns"):
        start, dur = event.start_ns(), event.duration_ns()
    else:  # older profilers count microseconds
        start, dur = 1000 * event.start_us(), 1000 * event.duration_us()
    return start + dur if end else start


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], e[last]


class Trace:
    """What one traced window holds, in seconds: ``window_s`` (the
    ``skbench::window`` span), ``busy_s`` (the union of the device's
    operations: kernels, copies and sets), each kernel's time and count by
    name, the host's time in ``SYNC_OP``, each span's total, and the idle
    gaps inside the window."""

    def __init__(self, events) -> None:
        dev_name, dev_s, dev_e = [], [], []
        span_ns: dict[str, list] = {}
        self.sync_s = 0.0
        window = None
        cuda = torch.autograd.DeviceType.CUDA
        for ev in events:
            name = ev.name()
            if name.startswith(PREFIX):
                start, end = _ns(ev, False), _ns(ev, True)
                if ev.device_type() == cuda:
                    continue  # the device's copy of a host range
                if name == PREFIX + "window":
                    window = (start, end)
                else:
                    span_ns.setdefault(name[len(PREFIX):], []).append((start, end))
            elif ev.device_type() == cuda:
                dev_name.append(name)
                dev_s.append(_ns(ev, False))
                dev_e.append(_ns(ev, True))
            elif name == SYNC_OP:
                self.sync_s += (_ns(ev, True) - _ns(ev, False)) * 1e-9
        if window is None:
            raise RuntimeError("the trace holds no skbench::window span")
        if not dev_name:
            raise RuntimeError("the trace holds no device events: the profiler saw no "
                               "kernel on the card")
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        s = np.clip(np.asarray(dev_s, np.int64), w0, w1)
        e = np.clip(np.asarray(dev_e, np.int64), w0, w1)
        us, ue = _union(s, e)
        self.busy_s = float((ue - us).sum()) * 1e-9
        names = np.asarray(dev_name, object)
        durs = (e - s) * 1e-9
        self.kernels: dict[str, tuple[int, float]] = {}
        for n, d in zip(names, durs):
            c, t = self.kernels.get(n, (0, 0.0))
            self.kernels[n] = (c + 1, t + float(d))
        self.spans = {k: sum(b - a for a, b in v) * 1e-9 for k, v in span_ns.items()}
        # idle gaps inside the window, each named by the innermost span at its midpoint
        gs = np.concatenate([[w0], ue])
        ge = np.concatenate([us, [w1]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        mid = (gs + ge) // 2
        label = np.full(len(mid), "between jobs", object)
        for span in SPAN_ORDER:
            if span not in span_ns:
                continue
            iv = np.asarray(sorted(span_ns[span]), np.int64)
            k = np.searchsorted(iv[:, 0], mid, side="right") - 1
            inside = (k >= 0) & (mid < iv[np.clip(k, 0, None), 1])
            label[inside] = span
        self.gaps_by_span: dict[str, float] = {}
        for lab, g in zip(label, (ge - gs) * 1e-9):
            self.gaps_by_span[lab] = self.gaps_by_span.get(lab, 0.0) + float(g)

    def kernel_seconds(self, *parts: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds any of
        ``parts``."""
        hits = [v for k, v in self.kernels.items() if any(p in k for p in parts)]
        return sum(c for c, _ in hits), sum(t for _, t in hits)

    def launches(self) -> int:
        """Kernel launches: device events that are not copies or sets."""
        return sum(c for k, (c, _) in self.kernels.items()
                   if not k.startswith(("Memcpy", "Memset")))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, t) for k, (_, t) in self.kernels.items()), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps_by_span.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, t] for k, t in ops[:top]],
                "idle_gaps": [[k, t] for k, t in gaps[:top]]}


def reduce_events(prof) -> Trace:
    """The :class:`Trace` of a finished profiler, read from its raw events
    (the profiler's own tree of events is not built: a window holds some
    hundreds of thousands of launches)."""
    return Trace(prof.profiler.kineto_results.events())
