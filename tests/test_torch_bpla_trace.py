"""``bpla_kernel -n`` on the CPU: its written Gram against the benchmark's
plain reference (``skbench.reference.bpla``), and its spans and counters.

One seeded corpus of 6 + 6 sequences of 30-40 nt runs through the CLI
twice, without a profiler and under a CPU one; the first run's log K is
kept as the benchmark keeps it (``skbench/capture/la_values.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from skbench.capture import la_values
from skbench.flows import Job
from skbench.harness import cell_of
from skbench.reference import bpla as reference
from stem_kernel_torch.cli import bpla_kernel
from stem_kernel_torch.models.featurize import pad_to
from stem_kernel_torch.utils import tracing
from stem_kernel_torch.utils.shuffle import dinucleotide_shuffle

SPANS = ("bpla_features", "bpla.factors", "la")


class _Spy:
    """Stands in for the profiler's range: records each range a span opens."""

    opened: list = []

    def __init__(self, name):
        self.opened.append(name)

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(corpus, output, log K records, counter deltas, opened without a
    profiler, the profiled run's ranges)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)  # beside other test workers, torch's pool slows small runs
    try:
        tmp = tmp_path_factory.mktemp("bpla")
        rng = np.random.default_rng(20)
        pos = ["".join(rng.choice(list("acgu"), int(rng.integers(30, 41)))) for _ in range(6)]
        neg = [dinucleotide_shuffle(s, rng) for s in pos]
        files = []
        for label, name, seqs in (("+1", "pos", pos), ("-1", "neg", neg)):
            f = tmp / f"{name}.fa"
            f.write_text("".join(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs)))
            files += [label, str(f)]
        out = tmp / "km.dat"
        argv = ["--device", "cpu", "-n", str(out), *files]
        records: dict = {}
        before = tracing.counters()
        real, _Spy.opened = tracing._RecordFunctionFast, []
        tracing._RecordFunctionFast = _Spy
        try:
            with la_values.capture(lambda: records):
                assert bpla_kernel.main(argv) == 0
        finally:
            tracing._RecordFunctionFast = real
        after = tracing.counters()
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert bpla_kernel.main(["--device", "cpu", "-n", str(tmp / "km2.dat"), *files]) == 0
        ranges = []
        for ev in prof.profiler.kineto_results.events():
            if ev.name().startswith(tracing.PREFIX):
                a = ev.start_ns()
                ranges.append((ev.name()[len(tracing.PREFIX):], a, a + ev.duration_ns()))
        yield {"pos": pos, "neg": neg}, out, records, delta, list(_Spy.opened), ranges
    finally:
        torch.set_num_threads(saved)


def test_gram_matches_the_plain_reference(runs):
    corpus, out, records, _, _, _ = runs
    job = Job(0, out.parent, corpus, [], out, records=records)
    config = cell_of("bpla.train").config
    checks = reference.check("train", job, None, config, np.random.default_rng(0),
                             torch.device("cpu"))
    # Both sides run the same plain f32 arithmetic on the CPU (the fold, the
    # profiles, the factors, the log-space DP and the float32 normalization),
    # so the gaps are the written text's rounding (15 digits) and nothing
    # else; the card's kernel is held to its own limits in the benchmark.
    assert checks["gram_gap"] <= 1e-6, checks
    assert checks["log_gap"] <= 1e-6, checks
    n = len(corpus["pos"]) + len(corpus["neg"])
    assert len(la_values.values(records)) == n * (n + 1) // 2


def test_spans_open_under_a_profiler_and_not_without(runs):
    _, _, _, _, opened, ranges = runs
    assert opened == []  # without a profiler no span opened a range
    by_name: dict = {}
    for name, a, b in ranges:
        by_name.setdefault(name, []).append((a, b))

    def inside(inner, outer):
        return all(any(a <= c and d <= b for a, b in by_name[outer]) for c, d in by_name[inner])

    for name in SPANS:
        assert by_name.get(name), name
    assert inside("bpla_features", "featurize")
    assert inside("bpla.factors", "kernel") and inside("la", "kernel")
    # two factor builds (x and y) and one LA call a Gram batch
    assert len(by_name["bpla.factors"]) == 2 * len(by_name["kernel"]) == 2 * len(by_name["la"])


def test_counters_count_the_grams_pairs_and_padded_cells(runs):
    corpus, _, _, delta, _, _ = runs
    seqs = corpus["pos"] + corpus["neg"]
    n = len(seqs)
    width = pad_to(max(len(s) for s in seqs))
    assert delta["bpla.sequences"] == n
    assert delta["la.la_log_factored.pairs"] == delta["gram.pairs"] == n * (n + 1) // 2
    assert delta["la.la_log_factored.cells_padded"] == n * (n + 1) // 2 * width * width
    assert delta.get("la.la_log_factored.calls", 0) == 0  # no kernel launch on the CPU
