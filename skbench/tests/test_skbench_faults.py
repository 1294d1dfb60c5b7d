"""A run with the timed path broken underneath reads ``correct`` false.

The harness runs here on the CPU (the CLIs' plain versions, a small
corpus), past its look for a chip.  The cells can have two of the
contract's faults: an answer altered where it is produced (the first pair
of every batch, 1%), and half of a batch left out, the mean of the rest in
its place.  A step that returns its state unchanged belongs to training,
and an exchange between chips to cells on several: neither exists here.
In ``stem_lite.train`` the same faults, and K1's values rounded to bf16,
are planted in the stem kernel alone (``stem_kernel_pairs``), below the
sum with the string kernel that the written Gram holds.
"""

import time

import numpy as np
import pytest
import torch

from skbench.harness import run_cell

from ._small import SEED, SMALL_CONFIG, SMALL_TRAFFIC

# the cell -> (module, name, log values, is a factory) of the function that
# produces its answers: the batched kernel (stem + string) that
# ``make_stem_lite_kernel_fn`` returns, and K6's log K
PRODUCERS = {
    "stem_lite.train": ("stem_kernel_torch.cli.stem_kernel_lite", "make_stem_lite_kernel_fn",
                        False, True),
    "stem_lite.predict": ("stem_kernel_torch.cli.stem_kernel_lite", "make_stem_lite_kernel_fn",
                          False, True),
    "full_stem.train": ("stem_kernel_torch.cli.stem_kernel", "full_stem_banded_log", True, False),
}


def altered(fn, log_values):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] = out[0] + np.log(1.01) if log_values else out[0] * 1.01
        return out
    return wrapped


def half_left_out(fn, log_values):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        h = (len(out) + 1) // 2
        if len(out) > 1:
            out[h:] = out[:h].mean()
        return out
    return wrapped


def bf16_rounded(fn, log_values):
    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs).to(torch.bfloat16).to(torch.float32)
    return wrapped


STEM = ("stem_kernel_torch.models.stem_kernel", "stem_kernel_pairs")


def _run(cell):
    return run_cell(cell, SEED, 0.01, False, t0=time.perf_counter(), device="cpu",
                    config_overrides=SMALL_CONFIG[cell],
                    traffic_overrides=SMALL_TRAFFIC.get(cell))


@pytest.mark.parametrize("cell", sorted(PRODUCERS))
@pytest.mark.parametrize("fault", [None, altered, half_left_out])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    module, name, log_values, factory = PRODUCERS[cell]
    if fault is not None:
        mod = __import__(module, fromlist=[name])
        fn = getattr(mod, name)
        broken = ((lambda *a, **k: fault(fn(*a, **k), log_values)) if factory
                  else fault(fn, log_values))
        monkeypatch.setattr(mod, name, broken)
    with torch.no_grad():
        result = _run(cell)
    if fault is None:
        assert result["correct"], result["checks"]
    else:
        assert not result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if cell == "stem_lite.train":
        assert "stem_gap" in result["checks"]


@pytest.mark.parametrize("fault", [altered, half_left_out, bf16_rounded])
def test_stem_kernel_fault_reads_incorrect(fault, monkeypatch):
    """K1 broken underneath the sum: ``stem_gap`` fails, whatever share of
    the written Gram the stem kernel is."""
    mod = __import__(STEM[0], fromlist=[STEM[1]])
    monkeypatch.setattr(mod, STEM[1], fault(getattr(mod, STEM[1]), False))
    with torch.no_grad():
        result = _run("stem_lite.train")
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks["stem_gap"]["value"] > checks["stem_gap"]["limit"], checks
