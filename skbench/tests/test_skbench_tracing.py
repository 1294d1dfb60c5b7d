"""The reduction of a traced window, on events made by hand; and one short
traced run on the card (skips without one)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from skbench.harness import ROOT, RunRecord, cell_of, read_metric
from skbench.flows import Job
from skbench.tracing import PREFIX, SYNC_OP, Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start_us, dur_us):
        self._n, self._d, self._s, self._t = name, dev, start_us * 1000, dur_us * 1000

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_union_idle_gaps_and_counts():
    events = [
        Ev(PREFIX + "window", CPU, 0, 100),
        Ev(PREFIX + "window", CUDA, 0, 100),  # the device's copy of a host range
        Ev(PREFIX + "job", CPU, 0, 100),
        Ev(PREFIX + "featurize", CPU, 10, 30),
        Ev(PREFIX + "gram", CPU, 50, 40),
        Ev("kernel_a", CUDA, 20, 10),
        Ev("kernel_b", CUDA, 25, 10),  # overlaps kernel_a: counted once in busy
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 60, 5),
        Ev("fixed_point_tiles<1>", CUDA, 70, 20),
        Ev(SYNC_OP, CPU, 55, 8),
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((15 + 5 + 20) * 1e-6)  # [20,35) [60,65) [70,90)
    assert t.sync_s == pytest.approx(8e-6)
    assert t.launches() == 3  # the copy is not a launch
    assert t.kernel_seconds("fixed_point_tiles") == (1, pytest.approx(20e-6))
    assert t.spans["featurize"] == pytest.approx(30e-6)
    gaps = t.gaps_by_span
    # idle [0,20) mid 10 -> featurize; [35,60) mid 47 -> job; [65,70) -> gram; [90,100) -> job
    assert gaps["featurize"] == pytest.approx(20e-6)
    assert gaps["job"] == pytest.approx(35e-6)
    assert gaps["gram"] == pytest.approx(5e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "fixed_point_tiles<1>"
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(t.window_s - t.busy_s)


def test_trace_without_device_events_fails():
    with pytest.raises(RuntimeError, match="no device events"):
        Trace([Ev(PREFIX + "window", CPU, 0, 10)])


@pytest.mark.parametrize("cell,metric", [("stem_lite.train", "k1_roofline.train"),
                                         ("full_stem.train", "k6_roofline.full_stem"),
                                         ("stem_lite.train", "featurize_share.train")])
def test_metric_with_nothing_to_read_fails_the_run(cell, metric, tmp_path):
    """A kernel or a span gone by the name the reader looks for: the traced
    run fails instead of leaving the metric out."""
    t = Trace([Ev(PREFIX + "window", CPU, 0, 100), Ev("renamed_kernel", CUDA, 10, 20)])
    job = Job(0, tmp_path, {"pos": ["GGGAAACCC"], "neg": ["GCGAAAGCA"]}, [], tmp_path / "o",
              pairs=3, records={"stem_features": [(np.arange(2), np.array([4, 5]),
                                                   np.array([1, 2]))]})
    run = RunRecord(cell_of(cell), 1.0, 100e-6, [job], t)
    with pytest.raises(RuntimeError, match="nothing to read"):
        read_metric(metric, run)


@pytest.mark.cuda
def test_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "skbench/run.py", "--workload", "full_stem.train",
                          "--seed", "5", "--seconds", "1", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "k6_roofline.full_stem" in result["metrics"]
