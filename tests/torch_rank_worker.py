"""One rank of tests/test_torch_parallel.py's two-rank runs of the port's CLIs.

Usage, with torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) set by the caller:

    python torch_rank_worker.py JOBS.json

JOBS.json holds ``{"batch_size": B, "jobs": [[cli, argv, expect_error],
...], "scaling": bool}``.  Each job calls
``stem_kernel_torch.cli.<cli>.main(argv)`` in this process through
:func:`counting_run_app`, so that a few sequences still make several
batches a rank; relative output paths land in the working directory, and
``job I pairs N`` gives the pairs this rank evaluated.  A job with
``expect_error`` must raise ValueError, and its message is printed.  With
``scaling``, ``scaling_efficiency`` of a small kernel on 1 and 2 ranks is
printed as JSON.  The last line is ``rank R: ok``.
"""

import importlib
import json
import sys

import numpy as np
import torch


def counting_run_app(batch_size: int, counter: list):
    """``cli.app.run_app`` at a Gram batch of ``batch_size``, adding the
    pairs each kernel call evaluates on this rank to ``counter[0]``."""
    from stem_kernel_torch.cli import app

    def run_app(opts, featurize, make_kernel_fn, **kw):
        def make(aux):
            fn = make_kernel_fn(aux)

            def counted(x, y):
                out = fn(x, y)
                counter[0] += len(out)
                return out
            return counted
        kw["batch_size"] = batch_size
        return app.run_app(opts, featurize, make, **kw)
    return run_app


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    from stem_kernel_torch.parallel.distributed import scaling_efficiency, world

    for i, (cli, argv, expect_error) in enumerate(spec["jobs"]):
        mod = importlib.import_module(f"stem_kernel_torch.cli.{cli}")
        pairs = [0]
        mod.run_app = counting_run_app(spec["batch_size"], pairs)
        if not expect_error:
            mod.main(argv)
            print(f"job {i} pairs {pairs[0]}", flush=True)
            continue
        try:
            mod.main(argv)
        except ValueError as exc:
            print(f"job {i} raised: {exc}", flush=True)
        else:
            print(f"job {i} did not raise", flush=True)
            return 1
    rank, _ = world()
    if spec["scaling"]:
        rng = np.random.default_rng(rank)

        def feats_fn(bsz):
            v = rng.random((bsz, 64), dtype=np.float32)
            return {"v": v}, {"v": v[::-1].copy()}

        eff = scaling_efficiency(lambda x, y: (x["v"] * y["v"]).sum(-1), feats_fn,
                                 batch_per_device=256, device_counts=[1, 2], device="cpu")
        print("scaling " + json.dumps(eff), flush=True)
    print(f"rank {rank}: ok", flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    raise SystemExit(main())
