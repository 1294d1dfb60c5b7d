"""Port parity: linear recurrence, profile scores and the string kernel.

The same numpy inputs (f32, from a seed) go through the JAX package and the
PyTorch port's CPU path.  Tolerance rtol 1e-5: f32 arithmetic in another
order (a Toeplitz product in place of an associative scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.models import string_kernel as jsk
from stem_kernel_tpu.ops.recurrence import linear_recurrence as j_linrec
from stem_kernel_torch.models import string_kernel as tsk
from stem_kernel_torch.ops.recurrence import linear_recurrence as t_linrec

rng = np.random.default_rng(11)


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_recurrence_matches_jax(reverse):
    b = rng.random((3, 5, 40)).astype(np.float32)
    want = np.asarray(j_linrec(jnp.float32(0.8), jnp.asarray(b), reverse=reverse))
    got = t_linrec(0.8, torch.as_tensor(b), reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _profiles(bsz, length, zero_cols=()):
    p = rng.random((bsz, length, 4)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    for c in zero_cols:
        p[:, c] = 0.0  # all-gap columns: score 1.0 by definition
    return p


@pytest.mark.parametrize("table", ["ribosum", "match"])
def test_profile_subst_scores_match_jax(table):
    subst = (jsk.ribosum_subst_table(0.2) if table == "ribosum"
             else jsk.match_mismatch_table(1.0, 0.8))
    px, py = _profiles(3, 17, zero_cols=(4,)), _profiles(3, 23, zero_cols=(0, 9))
    want = np.asarray(jsk.profile_subst_scores(jnp.asarray(px), jnp.asarray(py),
                                               jnp.asarray(subst)))
    got = tsk.profile_subst_scores(torch.as_tensor(px), torch.as_tensor(py),
                                   torch.as_tensor(subst)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 20, 30), (2, 33, 7)])
def test_gap_weighted_string_kernel_matches_jax(shape):
    scores = (rng.random(shape) * 0.9).astype(np.float32)
    want = np.asarray(jsk.gap_weighted_string_kernel(jnp.asarray(scores), 0.8))
    got = tsk.gap_weighted_string_kernel(torch.as_tensor(scores), 0.8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_string_kernel_module_matches_jax():
    """Weights and length masks, padded profiles of different lengths."""
    px, py = _profiles(4, 24), _profiles(4, 32)
    lx = np.array([24, 10, 17, 1], np.int32)
    ly = np.array([32, 30, 5, 12], np.int32)
    wx = rng.random((4, 24)).astype(np.float32)
    wy = rng.random((4, 32)).astype(np.float32)
    want = np.asarray(jsk.StringKernel(0.8, alpha=0.2)(
        jnp.asarray(px), lx, jnp.asarray(py), ly, jnp.asarray(wx), jnp.asarray(wy)))
    got = tsk.StringKernel(0.8, alpha=0.2)(
        torch.as_tensor(px), torch.as_tensor(lx), torch.as_tensor(py),
        torch.as_tensor(ly), torch.as_tensor(wx), torch.as_tensor(wy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_long_rows_stay_finite_and_match():
    """Ly = 512: the Toeplitz form has entries <= 1, where the cumsum of
    b * gap^-t shortcut would overflow f32 (gap^-511 ~ 1e49)."""
    scores = (rng.random((2, 12, 512)) * 0.5).astype(np.float32)
    want = np.asarray(jsk.gap_weighted_string_kernel(jnp.asarray(scores), 0.8))
    got = tsk.gap_weighted_string_kernel(torch.as_tensor(scores), 0.8).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
