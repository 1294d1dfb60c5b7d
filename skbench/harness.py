"""One run of one cell: set-up, the measured window, the check, the result.

A cell of ``BENCHMARK.json`` names a configuration (``skbench/configs/``,
through its ``file``) and a traffic mix (``skbench/traffic/<name>.json``).
The configuration names its CLI, its corpus generator
(``skbench/corpora/<name>.py``), its plain reference
(``skbench/reference/<name>.py``), what the check reads from the timed
path besides the written files (``skbench/capture/<name>.py``, by flow)
and the limits of the numbers that reference compares; the traffic mix
names its flow (``flows.FLOWS``).
Each metric is read by ``skbench/metrics/<name>.py``.  Adding a cell, a
mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stem_kernel_tpu")
CHECK_STREAM = 2  # numpy seed stream of the check's sample


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """A module from a file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"skbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def cell_of(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


@dataclass
class RunRecord:
    """What the metric readers read (``skbench/metrics/*.py``)."""

    cell: Cell
    setup_s: float
    window_s: float
    jobs: list  # the window's jobs (flows.Job)
    trace: object = None  # tracing.Trace of a --trace 1 run
    extra: dict = field(default_factory=dict)


def read_metric(name: str, run: RunRecord) -> float:
    """Metric ``name`` of a cell that lists it: a reader that finds nothing to
    read (a kernel or span gone by that name, a profile without its events)
    fails the run, since the cell's entry says it has something there."""
    value = load_file(HERE / "metrics" / f"{name}.py").read(run)
    if value is None:
        raise RuntimeError(f"metric {name}: nothing to read in this run of {run.cell.name}, "
                           "which BENCHMARK.json lists it for")
    if not (isinstance(value, float) and math.isfinite(value)):
        raise ValueError(f"metric {name}: {value!r} is not a finite float")
    return value


def steal_s() -> float:
    """Seconds the machine's CPUs, summed, were held by its host
    (``/proc/stat`` steal); 0 where the count is not kept."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Setup:
    """What a run of a cell is built from: the cell with its configuration
    and traffic, the flow that makes its jobs, its reference and the CLI."""

    cell: Cell
    flow: object
    reference: object
    main: object
    device: object  # torch.device

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def flow_name(self) -> str:
        return self.cell.traffic["flow"]


def prepare(workload: str, seed: int, device: str, tmp: Path, *, root: Path = ROOT,
            config_overrides: dict | None = None,
            traffic_overrides: dict | None = None) -> Setup:
    """The cell's set-up, its flow's files under ``tmp``.
    ``config_overrides`` and ``traffic_overrides`` replace top-level keys of
    the configuration and the traffic mix (the tests' small corpora, the
    program's other precision in ``control.py``)."""
    import torch

    from . import flows

    cell = cell_of(workload, root)
    cell.config = dict(cell.config, **(config_overrides or {}))
    cell.traffic = dict(cell.traffic, **(traffic_overrides or {}))
    config = cell.config
    gen = importlib.import_module(f"skbench.corpora.{config['corpus']['generator']}")
    reference = importlib.import_module(f"skbench.reference.{config['reference']}")
    main = importlib.import_module(f"stem_kernel_torch.cli.{config['cli']}").main
    flow = flows.FLOWS[cell.traffic["flow"]](config, cell.traffic, gen, seed, device, tmp)
    flow.setup()
    return Setup(cell, flow, reference, main, torch.device(device))


def captures(setup: Setup, records_of) -> contextlib.ExitStack:
    """The captures (``skbench/capture/<name>.py``) the configuration names
    for this flow, installed for the time of the block."""
    stack = contextlib.ExitStack()
    for name in setup.config.get("capture", {}).get(setup.flow_name, []):
        mod = importlib.import_module(f"skbench.capture.{name}")
        stack.enter_context(mod.capture(records_of))
    return stack


def judge(setup: Setup, jobs: list, seed: int, *, tf32: bool = False,
          log=sys.stderr) -> tuple[dict, object]:
    """The check: one job of ``jobs`` drawn from the seed against the plain
    reference (with ``tf32``, the control: the reference in TF32 in the
    program's place).  Returns ({number: (value, limit)}, the job); the run
    is correct when every value is within its limit (nan fails)."""
    rng = np.random.default_rng([seed, CHECK_STREAM])
    job = jobs[int(rng.integers(len(jobs)))]
    limits = setup.config["limits"][setup.flow_name]
    checks = {}
    failed = sum(1 for j in jobs if j.error)
    if failed:
        checks["failed_jobs"] = (float(failed), 0.0)
    try:
        values = setup.reference.check(setup.flow_name, job, setup.flow, setup.config, rng,
                                       setup.device, tf32=tf32)
    except Exception:  # a malformed output fails the check, with its cause
        print(f"check of job {job.index} raised:\n{traceback.format_exc()}", file=log)
        values = {"output_readable": 1.0}
        limits = dict(limits, output_readable=0.0)
    for name, value in values.items():
        checks[name] = (float(value), float(limits[name]))
    return checks, job


def is_correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())  # nan fails


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", root: Path = ROOT, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None, log=sys.stderr) -> dict:
    """Run the cell and return its result (the contract's keys, ``checks``
    last).  ``device`` "cpu" runs the CLIs' plain versions (the tests do)."""
    import torch

    from . import flows
    from . import tracing

    with tempfile.TemporaryDirectory(prefix="skbench-") as tmp:
        setup = prepare(workload, seed, device, Path(tmp), root=root,
                        config_overrides=config_overrides, traffic_overrides=traffic_overrides)
        cell, flow, main, dev = setup.cell, setup.flow, setup.main, setup.device
        cuda = dev.type == "cuda"
        warm = flow.make_job(-1)
        current = [warm]
        with captures(setup, lambda: current[0].records):
            flows.run_job(main, warm)
            if warm.error:
                raise RuntimeError(f"the warm-up job failed:\n{warm.error}")
            if trace and cuda:
                with tracing.profiler():  # the profiler's own first start is set-up
                    torch.ones(1, device=dev).add_(1)
                    torch.cuda.synchronize(dev)
            if cuda:
                torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - t0

            jobs: list = []
            prof = tracing.profiler() if trace else None
            span = (torch.profiler.record_function if trace
                    else (lambda _: contextlib.nullcontext()))
            with (tracing.spans(dev, lambda: current[0].records) if trace
                  else contextlib.nullcontext()), (prof or contextlib.nullcontext()):
                with span(tracing.PREFIX + "window"):
                    t_start, c_start, s_start = time.perf_counter(), time.process_time(), steal_s()
                    while True:
                        job = flow.make_job(len(jobs))
                        current[0] = job
                        with span(tracing.PREFIX + "job"):
                            flows.run_job(main, job)
                        jobs.append(job)
                        if time.perf_counter() - t_start >= seconds:
                            break
                    if cuda:
                        torch.cuda.synchronize(dev)
                    window_s = time.perf_counter() - t_start
                    window_cpu_s = time.process_time() - c_start
                    window_steal_s = steal_s() - s_start
        for job in jobs:
            if job.error:
                print(f"job {job.index} failed:\n{job.error}", file=log)
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        t_reduce = time.perf_counter()
        trace_record = tracing.reduce_events(prof) if trace else None
        reduce_s = time.perf_counter() - t_reduce
        del prof
        run = RunRecord(cell, setup_s, window_s, jobs, trace_record)
        metrics = {m["name"]: {"value": read_metric(m["name"], run), "unit": m["unit"]}
                   for m in (cell.per_layer if trace else cell.end_to_end)}

        # the check, once the program's state is freed
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks, job = judge(setup, jobs, seed, log=log)
        check_s = time.perf_counter() - t_check
        failed = sum(1 for j in jobs if j.error)

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips if cuda else 0, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": is_correct(checks), "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_record is not None:
        dev_info["busy_s"] = trace_record.busy_s
        dev_info["window_s"] = trace_record.window_s
        result["breakdown"] = trace_record.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    # the process's CPU time and the machine's steal tell a slower host from a stalled one
    print(f"window {window_s:.3f} s, {len(jobs)} jobs ({', '.join(f'{j.seconds:.3f}' for j in jobs)}"
          f" s; CPU {window_cpu_s:.3f} s: {', '.join(f'{j.cpu_seconds:.3f}' for j in jobs)} s;"
          f" steal {window_steal_s:.3f} s), set-up {setup_s:.3f} s, trace read {reduce_s:.3f} s,"
          f" check of job {job.index} {check_s:.3f} s", file=log)
    return result
