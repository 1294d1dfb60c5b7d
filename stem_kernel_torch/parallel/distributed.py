"""Multi-process bootstrap, the gather of pair values, and scaling efficiency.

Port of ``stem_kernel_tpu/parallel/distributed.py``, the replacement for the
reference's MPI process model (MPIState RAII,
stem_kernel/common/framework.h:418-433; mpirun rank spawning):

- :func:`initialize` joins a ``torch.distributed`` process group when the
  process was started as one rank of several (torchrun's launch contract,
  the analogue of the JAX package's ``JAX_*`` variables); a single-process
  run is a no-op;
- :func:`rank_device` is the GPU a rank drives: ``cuda:{LOCAL_RANK}``;
- :func:`global_mesh` is the mesh over every rank;
- :func:`gather_pair_values` merges each rank's pair values back into pair
  order on every rank, the reference's Ssend/Recv gather and stride replay
  (kernel_matrix.cpp:225-261);
- :func:`scaling_efficiency` measures pairs/s of a batched kernel on the
  first 1, 2, ... ranks.

The process group's backend is gloo.  Only host-side Gram values cross
ranks, N²·4 bytes once a Gram (160 KB at N = 200), so NCCL would buy
nothing; and NCCL refuses two ranks on one GPU, the only multi-rank layout
a one-card machine can run.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist


def initialize() -> None:
    """Join the process group of a multi-process launch; else do nothing.

    Launch contract (the mpirun analogue): ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` in each process's environment, as
    ``torchrun --nproc-per-node N`` sets them (with ``LOCAL_RANK``, which
    :func:`rank_device` reads).  Every Gram CLI calls this at startup
    (``cli.app.resolve_device``), so the CLIs themselves are the
    multi-process programs, like the reference's MPI mains.  A second call
    in one process is a no-op.
    """
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group("gloo", init_method="env://")


def world() -> tuple[int, int]:
    """(this process's rank, the number of ranks); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device) -> torch.device:
    """The device this rank runs on.  Under a process group, ``cuda``
    without an index is the GPU of ``LOCAL_RANK`` (0 when unset), made the
    current device; a ``LOCAL_RANK`` past the host's GPUs raises.  Every
    other device is returned as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local, count = int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} has no GPU: this host shows {count} CUDA "
                           f"device(s); start at most {count} ranks on it")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def global_mesh():
    """The mesh over every rank (pair-parallel Gram batches)."""
    from .mesh import default_mesh

    return default_mesh()


def gather_pair_values(local: np.ndarray, n_pairs: int, batch_size: int, mesh,
                       first: int = 0) -> np.ndarray:
    """The values of all ``n_pairs`` pairs, in pair order, on every rank.

    ``local`` holds this rank's batches (``parallel.mesh.shard_pairs`` with
    the same ``first``) one after another, ``batch_size`` slots each.  Every rank
    sends a buffer padded to the most batches a rank holds; the merge only
    copies, so the values are bit-exact (an all-gather, not a sum-reduce,
    which would turn -0.0 into +0.0)."""
    if n_pairs == 0:
        return np.empty(0, np.float32)
    n_batches = -(-n_pairs // batch_size)
    buf = torch.zeros(-(-n_batches // mesh.size) * batch_size, dtype=torch.float32)
    buf[: len(local)] = torch.from_numpy(np.ascontiguousarray(local, np.float32))
    parts = [buf]
    if mesh.size > 1:
        parts = [torch.empty_like(buf) for _ in range(mesh.size)]
        dist.all_gather(parts, buf, group=mesh.group)
    # batch b = k * size + j is slot k of the rank at position (first + j) % size
    parts = parts[first:] + parts[:first]
    merged = torch.stack(parts).view(mesh.size, -1, batch_size).transpose(0, 1).reshape(-1)
    return merged[:n_pairs].numpy()


SCALING_REPS = 3  # timed reps a rank count; the best is kept


def scaling_efficiency(kernel_fn, feats_fn, batch_per_device: int,
                       device_counts: list[int], device="cuda") -> dict[int, float]:
    """Strong-scaling throughput per rank count, ``{n_ranks: pairs/s}``.

    ``feats_fn(batch_size)`` builds a feature batch ``(x, y)`` (dicts of
    arrays or tensors with a leading batch axis); ``kernel_fn(x, y)``
    evaluates it.  For each count n every rank builds the batch of
    ``batch_per_device * n`` pairs, and ranks 0..n-1 each run their slice on
    their device.  A timed rep starts at a barrier of all ranks and lasts
    until the slowest rank has its values (a max over ranks), so every rank
    returns the same figures.  Every rank of the group must call this.
    """
    rank, n_ranks = world()
    dev = rank_device(device)
    out: dict[int, float] = {}
    for nd in device_counts:
        if nd > n_ranks:
            raise ValueError(f"{nd} ranks requested but only {n_ranks} are running")
        bsz = batch_per_device * nd
        part = slice(rank * batch_per_device, (rank + 1) * batch_per_device)
        x, y = ({k: torch.as_tensor(v, device=dev)[part] for k, v in f.items()}
                for f in feats_fn(bsz))

        def run() -> None:
            if rank < nd:
                with torch.no_grad():
                    kernel_fn(x, y)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

        run()  # warm-up: builds and loads the kernels
        best = float("inf")
        for _ in range(SCALING_REPS):
            if n_ranks > 1:
                dist.barrier()
            t0 = time.perf_counter()
            run()
            elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
            if n_ranks > 1:
                dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
            best = min(best, float(elapsed))
        out[nd] = bsz / best
    return out
