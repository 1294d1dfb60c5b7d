"""The port's spans and counters (``stem_kernel_torch.utils.tracing``).

A span is a profiler range ``stem_kernel::<name>`` while a profiler records
and the one shared no-op context otherwise; the counters are one
process-wide dict of host-known numbers.  A tiny ``stem_kernel_lite`` train
run on the CPU shows the flow's ranges nested as the program calls them and
the counters agreeing with the work it did.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stem_kernel_torch.cli import stem_kernel_lite
from stem_kernel_torch.models import string_kernel
from stem_kernel_torch.utils import tracing
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

CORE = "gggcgcaagcuugaaagcgcccauaggcuaacguagcuagcuuaagc"  # 47 nt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers, torch's thread pool
    makes small CLI runs many times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ranges(prof) -> list[tuple[str, int, int]]:
    """(name without the prefix, start ns, end ns) of the program's ranges."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(tracing.PREFIX):
            start = ev.start_ns()
            out.append((ev.name()[len(tracing.PREFIX):], start, start + ev.duration_ns()))
    return out


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_no_op():
    assert tracing.span("gram") is tracing.span("fold")
    with tracing.span("gram") as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1)
    assert _ranges(prof) == []  # the span above opened no range
    assert tracing.span("gram") is tracing.span("fold")  # and none after the profiler


def test_spans_are_profiler_ranges_nested_as_called():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(3).add_(1)
            with tracing.span("sibling"):
                pass
    got = {name: (name, a, b) for name, a, b in _ranges(prof)}
    assert set(got) == {"outer", "inner", "sibling"}
    assert _inside(got["inner"], got["outer"]) and _inside(got["sibling"], got["outer"])
    assert got["inner"][2] <= got["sibling"][1]


def test_counters_count_snapshot_and_reset():
    saved = tracing.counters()
    try:
        tracing.reset_counters()
        assert tracing.counters() == {}
        tracing.count("a")
        tracing.count("a", 4)
        tracing.count("b", 0)
        snap = tracing.counters()
        assert snap == {"a": 5, "b": 0}
        tracing.count("a")
        assert snap == {"a": 5, "b": 0}  # a snapshot, not a view
        assert tracing.counters()["a"] == 6
        tracing.reset_counters()
        assert tracing.counters() == {}
    finally:
        tracing.reset_counters()
        for name, n in saved.items():
            tracing.count(name, n)


def test_rank_files(monkeypatch):
    assert (tracing.trace_file(), tracing.counters_file()) == ("trace.json", "counters.json")
    monkeypatch.setattr(tracing, "world", lambda: (2, 4))
    assert tracing.trace_file() == "trace_rank2.json"
    assert tracing.counters_file() == "counters_rank2.json"


def test_stem_lite_train_run_counts_its_work_and_nests_its_stages(tmp_path, monkeypatch):
    rng = np.random.default_rng(18)
    pos = [CORE[int(rng.integers(0, 8)):] for _ in range(3)]
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    files = []
    for label, name, seqs in (("+1", "pos", pos), ("-1", "neg", neg)):
        f = tmp_path / f"{name}.fa"
        f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
        files += [label, str(f)]
    padded = []  # the padded length of every string-kernel call
    kernel = string_kernel.gap_weighted_string_kernel

    def recorded(scores, gap):
        padded.append(scores.shape[1])
        return kernel(scores, gap)

    monkeypatch.setattr(string_kernel, "gap_weighted_string_kernel", recorded)
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert stem_kernel_lite.main(["--device", "cpu", "-n", str(tmp_path / "km.dat"),
                                      *files]) == 0
    after = tracing.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    n = len(pos) + len(neg)
    assert delta("gram.pairs") == n * (n + 1) // 2
    assert delta("gram.batches") >= 1
    assert delta("fold.sequences") == n and delta("fold.batches") >= 1
    assert padded and delta("string.calls") == len(padded)
    assert delta("string.rows") == sum(padded)
    assert delta("k1.calls.cluster") == delta("k1.calls.tiles") == 0  # no kernel on the CPU

    ranges = _ranges(prof)
    by_name = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    flow = ("read", "featurize", "gram", "write")
    assert all(len(by_name[s]) == 1 for s in flow)
    starts = [by_name[s][0][1] for s in flow]
    assert starts == sorted(starts)  # the flow's stages in order
    # each inner range lies inside the one the program calls it from
    for inner, outer in (("fold", "featurize"), ("dag", "featurize"), ("pack", "featurize"),
                         ("block", "gram"), ("gather", "block"), ("kernel", "block"),
                         ("fetch", "block"), ("stem", "kernel"), ("k1", "stem"),
                         ("string", "kernel"), ("normalize", "gram")):
        assert by_name[inner], inner
        for r in by_name[inner]:
            assert any(_inside(r, o) for o in by_name[outer]), (inner, outer)
    assert len(by_name["kernel"]) == delta("gram.batches")
