"""Run one cell of the benchmark on this machine's GPU and print its result.

    python3 skbench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout of the repository.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``:
each number the check compared, beside its limit); the last lines of
standard error repeat the checks.  Exits non-zero, and prints no result,
without a CUDA device (or fewer than the cell asks for), without the
program (``stem_kernel_torch``), or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # the run's set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the checkout's root heads the search path, in place of this script's directory
    if Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from skbench.harness import cell_of, loaded_forbidden, run_cell

    cell = cell_of(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"skbench: the cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = loaded_forbidden()
    if found:
        print(f"skbench: the run loaded {', '.join(found)}; the benchmark measures "
              "stem_kernel_torch alone", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
