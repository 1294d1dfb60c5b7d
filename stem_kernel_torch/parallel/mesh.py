"""Pair meshes over torch.distributed ranks, and rank-0 I/O.

Port of ``stem_kernel_tpu/parallel/mesh.py``, the replacement for the
reference's MPI backend (stem_kernel/common/kernel_matrix.cpp:184-483).  A
mesh is the set of ranks, one GPU each, that share a Gram's pair batches.
The batches are dealt round robin, the reference's rank striding
(kernel_matrix.cpp:199-261): each job's batch 0 goes to the rank after the
one that took the previous job's last batch, so the many small blocks of a
bucketed Gram spread over the ranks too.  An all-gather
(``parallel.distributed.gather_pair_values``) hands every rank all the
values.  Rank-0-only I/O (framework.h:135-163) is :func:`process_zero`.

Departures from the JAX package:

- Each rank runs whole batches of the CLI's batch size, where the JAX
  engine rounds the batch to the mesh and gives each device a batch/W
  slice (``gram/engine.py:87-89``).  A batch then has exactly the
  composition it has in a one-rank run, so the values are bit-equal to one
  rank's even where a kernel's bits depend on its batch (a route picked
  from the batch's shapes).
- ``put`` and ``replicate`` have no counterpart: every rank builds its
  features from the same files on its own device, as every JAX process
  does, so no feature crosses ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from .distributed import world

PAIR_AXIS = "pairs"


@dataclass
class Mesh:
    """The ranks that share a Gram's pair batches, seen from one rank.

    ``ranks``: the global ranks taking part, in dealing order; ``rank``:
    this process's global rank (a rank outside ``ranks`` does no Gram work);
    ``group``: the process group over
    ``ranks`` (None in a single process); ``dealt``: batches dealt so far,
    the same on every rank, since every rank runs the same jobs."""

    ranks: tuple[int, ...]
    rank: int
    group: object = None
    dealt: int = 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's position in ``ranks``."""
        return self.ranks.index(self.rank)

    def deal(self, n_batches: int) -> int:
        """Deal a job of ``n_batches``: the position in ``ranks`` of the rank
        that takes its batch 0."""
        first = self.dealt % self.size
        self.dealt += n_batches
        return first


def default_mesh(ranks=None) -> Mesh:
    """Mesh over every rank of the process group (or the given ranks).
    Every rank of the group must call this: a subset gets a new group."""
    rank, n_ranks = world()
    ranks = tuple(range(n_ranks)) if ranks is None else tuple(ranks)
    if not dist.is_initialized():
        group = None
    elif ranks == tuple(range(n_ranks)):
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(ranks))
    return Mesh(ranks, rank, group)


def resolve_mesh(n_devices: int = 0) -> Mesh | None:
    """Mesh for a CLI run: ``n_devices`` = 0 means every rank, N the first N.

    The CLIs are the multi-process programs (``cli.app.run_app`` calls
    this on every rank).  Returns None (plain single-device dispatch, every
    rank computing the whole Gram) when one rank is left; raises
    ``ValueError`` when N exceeds the ranks running."""
    _, n_ranks = world()
    n = n_ranks if n_devices <= 0 else n_devices
    if n > n_ranks:
        msg = (f"--devices {n} requested but only {n_ranks} torch.distributed rank(s) "
               "are running (one GPU a rank)")
        if not dist.is_initialized():
            msg += (f"; start one process a GPU: torchrun --nproc-per-node {n} "
                    "-m stem_kernel_torch.cli.<cli> ...")
        raise ValueError(msg)
    if n == 1:
        return None
    return default_mesh(range(n))


def shard_pairs(mesh: Mesh | None, n_batches: int, first: int = 0) -> range:
    """The batches of a job of ``n_batches`` that this rank runs, when the
    rank at position ``first`` takes batch 0 (``Mesh.deal``)."""
    if mesh is None:
        return range(n_batches)
    return range((mesh.index - first) % mesh.size, n_batches, mesh.size)


def process_zero() -> bool:
    """True on the rank responsible for I/O (MPI rank-0 equivalent)."""
    return world()[0] == 0
