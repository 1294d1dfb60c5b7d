"""The readings the limits of ``correct`` are set from, at a cell's own load.

    python3 skbench/control.py --workload CELL --seeds 1 2 ... \
        [--control N] [--bf16 N]

In one process, for each seed: one job of the cell (the flow and corpus a
run of that seed makes first), then the harness's own check of it
(``harness.judge``: the same draw, reference, numbers and limits as a run),
three ways:

- ``program``: the job as the cell runs it (the readings a limit must
  clear), on every seed;
- ``control``: the same job judged against the reference in TF32 in the
  program's place (``tf32=True``), the nearest precision below the
  configuration's f32 (a sound limit fails it), on the first N seeds;
- ``bf16``: the job again at ``--precision default`` (the program's own
  bf16 products), on the first N seeds.

Prints one JSON line a seed, each way's numbers and whether it came out
correct, then the largest and smallest reading of each number.  The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(workload: str, seeds: list, control: int, bf16: int, device: str = "cuda",
             config_overrides=None, traffic_overrides=None, log=sys.stderr) -> list:
    """One dict a seed: {"seed", "program": {...}, "program_correct"[, "control": {...},
    "control_correct"][, "bf16": {...}, "bf16_correct"]}."""
    from skbench import flows
    from skbench.harness import captures, cell_of, is_correct, judge, prepare

    options = dict(cell_of(workload, ROOT).config["options"],
                   **(config_overrides or {}).get("options", {}))
    low = dict(config_overrides or {}, options=dict(options, **{"--precision": "default"}))
    out = []
    for n, seed in enumerate(seeds):
        row = {"seed": seed}
        ways = [("program", config_overrides)] + ([("bf16", low)] if n < bf16 else [])
        for label, overrides in ways:
            with tempfile.TemporaryDirectory(prefix="skbench-control-") as tmp:
                setup = prepare(workload, seed, device, Path(tmp), root=ROOT,
                                config_overrides=overrides,
                                traffic_overrides=traffic_overrides)
                job = setup.flow.make_job(0)
                with captures(setup, lambda: job.records):
                    flows.run_job(setup.main, job)
                if job.error:
                    raise RuntimeError(f"seed {seed} {label}: the job failed:\n{job.error}")
                checks = [(label, False)] + ([("control", True)]
                                             if label == "program" and n < control else [])
                for name, tf32 in checks:
                    t0 = time.perf_counter()
                    numbers, _ = judge(setup, [job], seed, tf32=tf32, log=log)
                    row[name] = {k: v for k, (v, _) in numbers.items()}
                    row[name + "_correct"] = is_correct(numbers)
                    row[name + "_s"] = time.perf_counter() - t0
                row[label + "_job_s"] = job.seconds
        print(json.dumps(row), file=log, flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skbench/control.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, metavar="N",
                   help="seeds (the first N) read with the TF32 control")
    p.add_argument("--bf16", type=int, default=0, metavar="N",
                   help="seeds (the first N) run again at --precision default")
    args = p.parse_args(argv)
    # the checkout's root heads the search path, in place of this script's directory
    if Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("skbench/control.py: no CUDA device", file=sys.stderr)
        return 3
    rows = readings(args.workload, args.seeds, args.control, args.bf16)
    summary = {}
    for key in ("program", "control", "bf16"):
        names = {n for r in rows if key in r for n in r[key]}
        for n in sorted(names):
            vals = [r[key][n] for r in rows if key in r]
            summary[f"{key}.{n}"] = {"max": max(vals), "min": min(vals), "n": len(vals)}
        judged = [r[key + "_correct"] for r in rows if key in r]
        if judged:
            summary[f"{key}.correct"] = {"true": sum(judged), "false": len(judged) - sum(judged)}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
