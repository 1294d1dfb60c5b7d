"""Unit-granular Gram-matrix checkpointing.

Port of ``stem_kernel_tpu/gram/checkpoint.py``.  The reference has no
in-run checkpointing: a failed multi-hour Gram run restarts from zero.
Here every unit of pairs lands in a durable memmap as soon as it is
computed, with a completion bitmap alongside; resume skips finished units.
Files:

    <path>.values.npy   float32 memmap over the flattened pair list
    <path>.done.npy     per-unit completion flags
    <path>.meta.json    {n, batch_size, n_pairs, fingerprint} sanity check

``batch_size`` here is the unit: the engine's ``slab_batches`` batches.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch


def _sample(value) -> tuple[tuple, str, np.ndarray]:
    """(shape, dtype name, 4096-element strided sample) of an array or a
    tensor; a tensor's sample is taken on its device and only it is copied
    to the host."""
    if isinstance(value, torch.Tensor):
        flat = value.reshape(-1)
        sample = flat[:: max(1, flat.numel() // 4096)].contiguous().cpu().numpy()
        return tuple(value.shape), str(sample.dtype), sample
    arr = np.asarray(value)
    flat = arr.ravel()
    return arr.shape, str(arr.dtype), flat[:: max(1, flat.size // 4096)]


def features_fingerprint(features, extra=None) -> str:
    """Cheap content fingerprint of a feature mapping (arrays or tensors).

    Hashes every entry's key, shape, dtype, and a 4096-element strided
    value sample: enough to distinguish different corpora that produce
    identically-shaped buckets, at negligible cost for GB-scale features.
    Equal to the JAX package's fingerprint of the same arrays.
    """
    h = hashlib.sha1()
    for mapping in (features, extra):
        if mapping is None:
            continue
        for key in sorted(mapping):
            shape, dtype, sample = _sample(mapping[key])
            h.update(key.encode())
            h.update(str(shape).encode())
            h.update(dtype.encode())
            if sample.size:
                h.update(np.ascontiguousarray(sample).tobytes())
    return h.hexdigest()


class TileCheckpoint:
    def __init__(self, path: str, n: int, batch_size: int,
                 n_pairs: int | None = None, fingerprint: str | None = None):
        """``n_pairs`` defaults to the upper triangle n(n+1)/2; rectangular
        blocks (bucketed Gram cross blocks) pass it explicitly.
        ``fingerprint`` (features_fingerprint of the corpus) is stored in the
        meta and checked on resume, so a checkpoint written for one corpus is
        rejected for another even when every block size matches."""
        self.path = path
        self.n = n
        self.batch_size = batch_size
        self.n_pairs = n * (n + 1) // 2 if n_pairs is None else n_pairs
        self.n_batches = -(-self.n_pairs // batch_size)
        meta_path = path + ".meta.json"
        values_path = path + ".values.npy"
        done_path = path + ".done.npy"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            # checkpoints without n_pairs always held the upper triangle
            meta.setdefault("n_pairs", meta.get("n", 0) * (meta.get("n", 0) + 1) // 2)
            # a meta without a fingerprint is accepted (as in the JAX
            # package), a mismatched one never; a None fingerprint (direct
            # inspection, tests) accepts any
            meta.setdefault("fingerprint", fingerprint)
            if fingerprint is None:
                fingerprint = meta["fingerprint"]
            if meta != {"n": n, "batch_size": batch_size,
                        "n_pairs": self.n_pairs, "fingerprint": fingerprint}:
                raise ValueError(
                    f"checkpoint {path} was written for {meta}, "
                    f"not n={n} batch_size={batch_size} "
                    f"fingerprint={fingerprint}"
                )
            self.values = np.lib.format.open_memmap(values_path, mode="r+")
            self.done = np.lib.format.open_memmap(done_path, mode="r+")
        else:
            self.values = np.lib.format.open_memmap(
                values_path, mode="w+", dtype=np.float32, shape=(self.n_pairs,)
            )
            self.done = np.lib.format.open_memmap(
                done_path, mode="w+", dtype=np.bool_, shape=(self.n_batches,)
            )
            with open(meta_path, "w") as f:
                json.dump({"n": n, "batch_size": batch_size,
                           "n_pairs": self.n_pairs, "fingerprint": fingerprint}, f)

    def is_done(self, batch_idx: int) -> bool:
        return bool(self.done[batch_idx])

    def load_batch(self, batch_idx: int) -> np.ndarray:
        lo = batch_idx * self.batch_size
        hi = min(lo + self.batch_size, self.n_pairs)
        return np.asarray(self.values[lo:hi])

    def store_batch(self, batch_idx: int, vals: np.ndarray) -> None:
        lo = batch_idx * self.batch_size
        hi = min(lo + self.batch_size, self.n_pairs)
        self.values[lo:hi] = vals[: hi - lo]
        self.values.flush()
        self.done[batch_idx] = True
        self.done.flush()

    @property
    def n_completed(self) -> int:
        return int(self.done.sum())
