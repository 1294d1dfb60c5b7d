"""The control, the reference with TF32 products in the program's place,
comes out not correct by the harness's own check; the program, run as the
configuration states, comes out correct: at a size a CPU test run can
hold.  (On the chip at the cells' own sizes: ``python3
skbench/control.py``, PERF.md.)"""

import pytest

from skbench.control import readings
from skbench.harness import cell_of

from ._small import SEED, SMALL_CONFIG, SMALL_TRAFFIC


@pytest.mark.parametrize("cell", sorted(SMALL_CONFIG))
def test_control_fails_a_number_and_the_program_none(cell):
    c = cell_of(cell)
    limits = c.config["limits"][c.traffic["flow"]]
    (row,) = readings(cell, [SEED], 1, 0, device="cpu", config_overrides=SMALL_CONFIG[cell],
                      traffic_overrides=SMALL_TRAFFIC.get(cell))
    assert set(row["program"]) == set(limits), row
    assert row["program_correct"], row
    assert not row["control_correct"], row
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row
