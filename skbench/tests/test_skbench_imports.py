"""The harness and its reference load neither JAX nor the JAX package, and
the reference loads nothing of the program: checked in a fresh
interpreter, by whole top-level module names."""

import json
import subprocess
import sys

from skbench.harness import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import skbench.reference.stem_lite, skbench.reference.full_stem
import skbench.reference.plain.stem, skbench.reference.plain.banded
ref_top = sorted({{m.split(".")[0] for m in sys.modules}})
import skbench.harness, skbench.flows, skbench.tracing, skbench.control, skbench.roofline
from skbench.harness import HERE, load_file
for p in sorted((HERE / "metrics").glob("*.py")):
    load_file(p)
for g in ("family", "mixed"):
    __import__("skbench.corpora." + g)
print(json.dumps({{"ref": ref_top, "all": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_no_jax_and_reference_independent_of_the_program():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for bad in ("jax", "jaxlib", "flax", "stem_kernel_tpu"):
        assert bad not in mods["all"], bad
    assert "stem_kernel_torch" not in mods["ref"]
    # the port's name begins with the JAX package's: names compare whole
    assert "stem_kernel_tpu" != "stem_kernel_torch"
