"""Port parity: the scaled McCaskill fold (LUTs, inside, outside).

The port's f32 engine against the JAX package's f32 scaled engine on the
same codes, and against the f64 log-space goldens, at the bands of
tests/test_fold_goldens.py: BPP atol 5e-4, logZ rtol 2e-5.
"""

import dataclasses
import os

import numpy as np
import pytest

from stem_kernel_tpu.fold.mccaskill_scaled import mccaskill_bpp_batch_scaled as j_fold
from stem_kernel_tpu.fold.params import default_params as j_default_params
from stem_kernel_tpu.fold.params import fast_variant as j_fast_variant
from stem_kernel_torch.convert import energy_params_from_numpy
from stem_kernel_torch.fold.bpmatrix import fold_sequences
from stem_kernel_torch.fold.mccaskill_scaled import mccaskill_bpp_batch_scaled as t_fold
from stem_kernel_torch.io.alphabet import encode

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fold_bpp.npz")
BPP_ATOL, LOGZ_RTOL = 5e-4, 2e-5


def _j_params(variant):
    p = j_default_params()
    if variant == "fast":
        p = j_fast_variant(p)
    elif variant == "noGU":
        p.no_gu = True
    elif variant == "noClosingGU_noLP":
        p.no_closing_gu = True
        p.no_lonely_pairs = True
    return p


def _batch(n=48, lens=(48, 41, 30, 17), seed=3):
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lens), n), np.uint8)
    for i, L in enumerate(lens):
        # GC-rich halves that can fold back on each other
        half = rng.integers(0, 4, L // 2)
        comp = np.array([3, 2, 1, 0])[half[::-1]]
        seq = np.concatenate([half, rng.integers(0, 4, L - 2 * len(half)), comp])
        mut = rng.random(L) < 0.15
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        codes[i, :L] = seq
    return codes, np.asarray(lens, np.int32)


@pytest.mark.parametrize("variant", ["default", "fast", "noGU", "noClosingGU_noLP"])
def test_scaled_fold_matches_jax(variant):
    codes, lens = _batch()
    jp = _j_params(variant)
    want_bpp, want_z = j_fold(codes, lens, jp)
    got_bpp, got_z = t_fold(codes, lens, energy_params_from_numpy(dataclasses.asdict(jp)),
                            device="cpu")
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=LOGZ_RTOL)
    np.testing.assert_allclose(got_bpp.numpy(), np.asarray(want_bpp), atol=BPP_ATOL)
    assert got_bpp.dtype.is_floating_point and got_bpp.dtype.itemsize == 4


def test_scaled_fold_matches_goldens():
    data = np.load(GOLDEN)
    names = sorted({k.split("__")[0] for k in data.files})
    seqs = [data[f"{n}__seq"].tobytes().decode() for n in names]
    nmax = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), nmax), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode(s)
        lens[i] = len(s)
    bpps, zs = t_fold(codes, lens, device="cpu")
    for i, (name, s) in enumerate(zip(names, seqs)):
        m = len(s)
        np.testing.assert_allclose(zs[i].item(), data[f"{name}__logz"], rtol=LOGZ_RTOL,
                                   err_msg=f"logZ drift on {name}")
        np.testing.assert_allclose(bpps[i, :m, :m].numpy(), data[f"{name}__bpp"],
                                   atol=BPP_ATOL, err_msg=f"BPP drift on {name}")
    # the facade returns the same matrices per sequence, unpadded
    per_seq = fold_sequences(seqs[:3], device="cpu")
    for i in range(3):
        np.testing.assert_allclose(per_seq[i], data[f"{names[i]}__bpp"], atol=BPP_ATOL)
