"""The program's view of a traced window (``skbench/program_trace.py``), on
events made by hand."""

import numpy as np
import pytest
import torch

from skbench import program_trace as pt
from skbench import tracing
from skbench.tracing import PREFIX, SYNC_OP

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


def P(name):
    return pt.PROGRAM + name


EVENTS = [
    Ev(PREFIX + "window", CPU, 0, 100),
    Ev(PREFIX + "job", CPU, 0, 100),
    Ev(P("gram"), CPU, 10, 70),
    Ev(P("kernel"), CPU, 20, 30),
    Ev(P("string"), CPU, 25, 20),
    Ev(P("kernel"), CPU, 60, 20),
    Ev(P("gram"), CUDA, 22, 50),  # a device copy of a program range: not device work
    Ev("kernel_a", CUDA, 30, 10),
    Ev("full_stem_level", CUDA, 65, 10),
    Ev(SYNC_OP, CPU, 27, 1),
    Ev(SYNC_OP, CPU, 85, 1),
]


def test_spans_self_times_and_idle_by_innermost_range():
    got = pt.reduce_program(EVENTS, tracing)
    spans = got["program_spans"]
    assert spans["gram"]["count"] == 1 and spans["kernel"]["count"] == 2
    assert spans["gram"]["total_s"] == pytest.approx(70e-6)
    assert spans["gram"]["self_s"] == pytest.approx(20e-6)  # 70 less the kernels' 30 + 20
    assert spans["kernel"]["self_s"] == pytest.approx(30e-6)  # 50 less string's 20
    assert spans["string"]["self_s"] == pytest.approx(20e-6)
    assert got["busy_s"] == pytest.approx(20e-6)  # the copy of gram is not device work
    assert got["program_ranges_on_device"] == 1
    # idle [0,30) mid 15 -> gram; [40,65) mid 52 -> gram; [75,100) mid 87 -> none
    assert got["program_gaps"] == {"gram": pytest.approx(55e-6), "none": pytest.approx(25e-6)}
    assert sum(got["program_gaps"].values()) == pytest.approx(got["window_s"] - got["busy_s"])
    assert got["syncs_per_job"] == [2]
    assert got["syncs_by_range"] == {"string": 1, "none": 1}


def test_innermost_range_at_points():
    ranges = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    _, starts, names = pt.nest(ranges, 0, 120)
    points = np.array([5, 15, 25, 35, 55, 65, 110])
    assert pt.innermost(points, starts, names) == ["a", "b", "c", "b", "a", "d", "none"]
    assert pt.innermost(points, np.array([], np.int64), []) == ["none"] * len(points)


def test_k6_timeline():
    ranges = [(0, 10, "k6.sync"), (12, 40, "k6.setup"), (50, 60, "k6.sync"), (61, 90, "k6.setup")]
    got = pt.k6_timeline(ranges, np.array([20, 70]), np.array([15, 20, 65, 70]))
    assert got["batches"] == 2
    assert got["sync_us"] == pytest.approx(10e-3)
    assert got["sync_end_to_setup_us"] == pytest.approx(1.5e-3)
    assert got["sync_end_to_first_device_op_us"] == pytest.approx(5e-3)
    assert got["sync_end_to_first_level_us"] == pytest.approx(10e-3)
    assert pt.k6_timeline([], np.array([]), np.array([])) == {}
