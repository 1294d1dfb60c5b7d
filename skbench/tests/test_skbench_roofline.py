"""K1's and K6's least times on hand-worked toy pairs, counted unpadded."""

import numpy as np
import pytest

from skbench import roofline as r


def test_k1_counts_unpadded_nodes_and_trips():
    # one pair, nx = 3, ny = 5, 2 trips, f32 ("highest")
    products = 2 * 4 * 3 * 5 * (3 + 5)  # 960
    elementwise = 2 * 2 * 3 * 5 + 2 * 3 * 5  # 90
    nbytes = 4 * (2 * 15 + 2 * 9 + 2 * 25 + 3 + 5 + 2)  # 432
    want = max(nbytes / r.PEAK_BYTES, products / r.PEAK_F32 + elementwise / r.PEAK_F32)
    assert r.k1_seconds([3], [5], [2], "highest") == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(nbytes / r.PEAK_BYTES)  # a toy pair is bound by bytes


def test_k1_modes_and_sums():
    nx, ny, trips = np.array([100, 60]), np.array([200, 60]), np.array([10, 4])
    ops = (10 * 4 * 100 * 200 * 300 + 4 * 4 * 60 * 60 * 120)
    ew = (10 * 2 * 100 * 200 + 2 * 100 * 200) + (4 * 2 * 3600 + 2 * 3600)
    for prec, (peak, passes) in r.K1_PEAKS.items():
        want = ops * passes / peak + ew / r.PEAK_F32
        assert r.k1_seconds(nx, ny, trips, prec) == pytest.approx(want, rel=1e-12)
    # padding the node counts is more work: the count never sees it
    assert r.k1_seconds([112], [208], [10], "high") > r.k1_seconds([100], [200], [10], "high")


def test_k6_counts_windows_and_cells():
    # lx = 4, ly = 2, band 1: L = 4 levels, 10 windows of 3 x 3 cells
    cells = 10 * 9
    nbytes = 4 + 2 + 4 * (16 + 4) + 12
    want = max(nbytes / r.PEAK_BYTES, cells * r.K6_OPS / r.PEAK_F32)
    assert r.k6_seconds([4], [2], 1) == pytest.approx(want, rel=1e-12)
    # symmetric in the pair, additive over pairs in its operation count
    assert r.k6_seconds([2], [4], 1) == r.k6_seconds([4], [2], 1)
    big = r.k6_seconds([300, 200], [250, 80], 16)
    assert big == pytest.approx((300 * 301 / 2 + 200 * 201 / 2) * 33**2 * r.K6_OPS / r.PEAK_F32)
