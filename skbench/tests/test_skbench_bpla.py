"""The ``bpla.train`` cell on the CPU at a small corpus: it reads ``correct``,
the faults of ``test_skbench_faults.py`` planted in K2's log K read
``correct: false``, and the TF32 control fails while the program passes;
K2's least time counts unpadded cells; its metric readers read a traced
window made by hand; its reference and readers load neither JAX, nor the
JAX package, nor the program."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from skbench import roofline as r
from skbench import roofline_la as rla
from skbench.control import readings
from skbench.flows import Job
from skbench.harness import HERE, ROOT, RunRecord, cell_of, read_metric, run_cell
from skbench.tracing import PREFIX, Trace

from ._small import SEED
from .test_skbench_faults import altered, half_left_out
from .test_skbench_tracing import CPU, CUDA, Ev

CELL = "bpla.train"
SMALL = {"corpus": {"generator": "family", "per_class": 3, "core_lengths": [30, 34],
                    "model_core_length": 32, "core_seed": 7, "mutation": 0.1}}
K2 = ("stem_kernel_torch.models.bpla", "la_log_factored")  # the name log_value calls


@pytest.mark.parametrize("fault", [None, altered, half_left_out])
def test_fault_reads_incorrect(fault, monkeypatch):
    if fault is not None:
        mod = __import__(K2[0], fromlist=[K2[1]])
        monkeypatch.setattr(mod, K2[1], fault(getattr(mod, K2[1]), True))
    with torch.no_grad():
        result = run_cell(CELL, SEED, 0.01, False, t0=time.perf_counter(), device="cpu",
                          config_overrides=SMALL)
    checks = result["checks"]
    assert set(checks) == {"gram_gap", "log_gap"}, checks
    assert result["correct"] == (fault is None), checks
    if fault is not None:
        assert checks["log_gap"]["value"] > checks["log_gap"]["limit"], checks


def test_control_fails_a_number_and_the_program_none():
    limits = cell_of(CELL).config["limits"]["train"]
    (row,) = readings(CELL, [SEED], 1, 0, device="cpu", config_overrides=SMALL)
    assert row["program_correct"] and not row["control_correct"], row
    assert any(row["control"][k] > limits[k] for k in limits), row


def test_k2_counts_unpadded_cells_and_pairs():
    # two pairs, 30 x 34 and 40 x 40 nt: cells and bytes from the lengths
    cells = 30 * 34 + 40 * 40
    ops = cells * (rla.LA_LOG_OPS + 2 * rla.K2_RANK)
    nbytes = 4 * 6 * (30 + 34) + 12 + 4 * 6 * (40 + 40) + 12
    want = max(nbytes / r.PEAK_BYTES, ops / r.PEAK_F32)
    assert rla.k2_seconds([30, 40], [34, 40]) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(ops / r.PEAK_F32)  # bound by operations
    assert rla.k2_seconds([34], [30]) == rla.k2_seconds([30], [34])


def test_readers_on_a_traced_window():
    events = [
        Ev(PREFIX + "window", CPU, 0, 1000),
        Ev(PREFIX + "job", CPU, 0, 1000),
        Ev(PREFIX + "gram", CPU, 500, 400),
        Ev("void (anonymous namespace)::la_log_lanes<32, 4>(float const*)", CUDA, 600, 20),
        Ev("void (anonymous namespace)::la_dp<false, true, 6>(float const*)", CUDA, 700, 5),
        Ev("void at::native::elementwise_kernel<128, 2>", CUDA, 100, 75),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 880, 10),
    ]
    seqs = {"pos": ["a" * 30, "c" * 34], "neg": ["g" * 30, "u" * 34]}
    job = Job(0, ROOT, seqs, [], ROOT / "km.dat", pairs=10)
    run = RunRecord(cell_of(CELL), 1.0, 1e-3, [job], Trace(events))
    lens = np.array([30, 34, 30, 34])
    ix, iy = np.triu_indices(4)
    got = {m["name"]: read_metric(m["name"], run) for m in cell_of(CELL).per_layer}
    assert got["k2_roofline.bpla"] == pytest.approx(
        100 * rla.k2_seconds(lens[ix], lens[iy]) / 25e-6)
    assert got["device_idle.bpla"] == pytest.approx(100 * (1 - 110 / 1000))
    assert got["launches_per_kpair.bpla"] == pytest.approx(3 / 0.01)
    assert got["gram_share.bpla"] == pytest.approx(40.0)


PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import skbench.reference.bpla, skbench.reference.plain.bpla, skbench.roofline_la
from skbench.harness import HERE, load_file
for p in sorted((HERE / "metrics").glob("*.bpla.py")):
    load_file(p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_and_readers_load_no_jax_and_not_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for bad in ("jax", "jaxlib", "flax", "stem_kernel_tpu", "stem_kernel_torch"):
        assert bad not in mods, bad
    assert len(list((HERE / "metrics").glob("*.bpla.py"))) == 4
