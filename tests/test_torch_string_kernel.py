"""Port parity: linear recurrence, profile scores and the string kernel.

The same numpy inputs (f32, from a seed) go through the JAX package and the
PyTorch port's CPU path.  Tolerance rtol 1e-5: f32 arithmetic in another
order (a Toeplitz product in place of an associative scan).

The string kernel's CUDA DP kernel (ops/string_dp.py): its argument checks
and the routing by device run here, on CPU and meta tensors; the ``cuda``
cases hold it to the plain row loop on the card within rel 1e-4 (f32 sums
of positive terms in another order, over a few hundred dependent steps)
and a pair's value to the same bits at any batch size, position and pad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.models import string_kernel as jsk
from stem_kernel_tpu.ops.recurrence import linear_recurrence as j_linrec
from stem_kernel_torch.models import string_kernel as tsk
from stem_kernel_torch.ops import string_dp
from stem_kernel_torch.ops.recurrence import linear_recurrence as t_linrec
from stem_kernel_torch.utils import tracing

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


def test_reference_is_the_cpu_route():
    """On CPU tensors the module and the score-tensor kernel run the plain
    loop: bit-equal to the reference functions, rows counted."""
    px, py = _profiles(3, 20), _profiles(3, 26)
    args = (torch.as_tensor(px), torch.tensor([20, 7, 1], dtype=torch.int32),
            torch.as_tensor(py), torch.tensor([26, 26, 3], dtype=torch.int32))
    kern = tsk.StringKernel(0.8, match=1.0, mismatch=0.8)
    before = tracing.counters()
    got = kern(*args)
    after = tracing.counters()
    assert torch.equal(got, kern.reference(*args))
    assert after.get("string.rows", 0) - before.get("string.rows", 0) == 20
    assert after.get("string.calls.kernel", 0) == before.get("string.calls.kernel", 0)
    scores = torch.as_tensor((rng.random((2, 9, 40)) * 0.9).astype(np.float32))
    assert torch.equal(tsk.gap_weighted_string_kernel(scores, 0.6),
                       tsk.gap_weighted_string_kernel_reference(scores, 0.6))


def _profile_args(b=2, lx=5, ly=7, device="cpu"):
    """Valid arguments of string_dp_profile, in its order."""
    return {"px": torch.zeros((b, lx, 4), device=device),
            "py": torch.zeros((b, ly, 4), device=device),
            "subst": torch.zeros((4, 4), device=device),
            "wx": torch.zeros((b, lx), device=device), "wy": torch.zeros((b, ly), device=device),
            "lx": torch.zeros(b, dtype=torch.int32, device=device),
            "ly": torch.zeros(b, dtype=torch.int32, device=device)}


@pytest.mark.parametrize("name, bad, match", [
    ("px", torch.zeros((2, 5)), "px must be"),
    ("px", torch.zeros((2, 5, 5)), "shape"),
    ("py", torch.zeros((3, 7, 4)), "shape"),
    ("subst", torch.zeros((4, 5)), "shape"),
    ("wx", torch.zeros((2, 6)), "shape"),
    ("wy", torch.zeros((2, 7), dtype=torch.float64), "float32"),
    ("lx", torch.zeros(2, dtype=torch.int64), "int32"),
    ("ly", torch.zeros(3, dtype=torch.int32), "shape"),
    ("py", torch.zeros((2, 4, 7)).transpose(1, 2), "contiguous"),
    ("wx", torch.zeros((2, 5), requires_grad=True), "requires grad"),
    ("py", torch.zeros((2, string_dp.MAX_LY + 1, 4), device="meta"), "limit"),
    (None, None, "runs on cuda, not cpu"),
])
def test_profile_wrapper_rejects(name, bad, match):
    """The CUDA wrapper's checks that need no card (CPU and meta tensors)."""
    args = _profile_args(ly=string_dp.MAX_LY + 1 if match == "limit" else 7,
                         device="meta" if match == "limit" else "cpu")
    if name is not None:
        args[name] = bad
    with pytest.raises(ValueError, match=match):
        string_dp.string_dp_profile(*args.values(), gap=0.8)


@pytest.mark.parametrize("scores, match", [
    (torch.zeros((2, 5)), "scores must be"),
    (torch.zeros((2, 5, 7), dtype=torch.float64), "float32"),
    (torch.zeros((2, 7, 5)).transpose(1, 2), "contiguous"),
    (torch.zeros((2, 5, 7), requires_grad=True), "requires grad"),
    (torch.zeros((1, 1, string_dp.MAX_LY + 1), device="meta"), "limit"),
    (torch.zeros((2, 5, 7), device="meta"), "runs on cuda, not meta"),
    (torch.zeros((2, 5, 7)), "runs on cuda, not cpu"),
])
def test_scores_wrapper_rejects(scores, match):
    with pytest.raises(ValueError, match=match):
        string_dp.string_dp_scores(scores, 0.8)


def test_non_cpu_tensors_route_to_the_kernel():
    """A tensor off the CPU takes the kernel's wrapper, never the plain loop:
    on meta tensors both routes raise the wrapper's device error."""
    kern = tsk.StringKernel(0.8, alpha=0.2).to("meta")
    a = _profile_args(device="meta")
    before = tracing.counters()
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        kern(a["px"], a["lx"], a["py"], a["ly"], a["wx"], a["wy"])
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        kern(a["px"], a["lx"], a["py"], a["ly"])  # weights made on the inputs' device
    with pytest.raises(ValueError, match="runs on cuda, not meta"):
        tsk.gap_weighted_string_kernel(torch.zeros((2, 5, 7), device="meta"), 0.8)
    after = tracing.counters()
    assert after.get("string.rows", 0) == before.get("string.rows", 0)


def _cuda_case(seed, b, widths, wmax=1.0):
    """[px, lx, py, ly, wx, wy] on the card: Dirichlet columns, a tenth all
    gap, a tenth of the weights 0, the rest U(0, wmax), lengths 1..width."""
    g = np.random.default_rng(seed)
    out = []
    for width in widths:
        p = g.dirichlet(np.ones(4), size=(b, width)).astype(np.float32)
        p[g.random((b, width)) < 0.1] = 0.0
        w = g.uniform(0, wmax, (b, width)).astype(np.float32)
        w[g.random((b, width)) < 0.1] = 0.0
        n = g.integers(1, width + 1, b).astype(np.int32)
        n[0] = width
        out.append((p, n, w))
    (px, lx, wx), (py, ly, wy) = out
    return [torch.as_tensor(a).cuda() for a in (px, lx, py, ly, wx, wy)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


def _kernel_calls():
    return tracing.counters().get("string.calls.kernel", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["ribosum", "match"])
@pytest.mark.parametrize("widths", [(1, 33), (31, 32), (32, 31), (33, 1), (150, 31),
                                    (150, 150), (1500, 150), (150, 1500)])
def test_cuda_profile_kernel_matches_plain_loop(table, widths):
    _cuda_or_skip()
    kern = (tsk.StringKernel(0.8, alpha=0.2) if table == "ribosum"
            else tsk.StringKernel(0.8, match=1.0, mismatch=0.8)).cuda()
    case = _cuda_case(19, 8, widths, wmax=1.0 if max(widths) <= 150 else 0.3)
    calls, rows = _kernel_calls(), tracing.counters().get("string.rows", 0)
    got = kern(*case)
    torch.cuda.synchronize()
    assert _kernel_calls() == calls + 1
    assert tracing.counters().get("string.rows", 0) == rows
    want = kern.reference(*case)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(1, 33), (31, 32), (32, 31), (33, 1), (150, 31),
                                    (150, 150), (1500, 150)])
def test_cuda_scores_kernel_matches_plain_loop(widths):
    """The exact-match scores of the string_kernel CLI, a given tensor."""
    _cuda_or_skip()
    g = np.random.default_rng(20)
    gap = 0.8 if max(widths) <= 150 else 0.5
    x, y = (torch.as_tensor(g.integers(0, 4, (8, w)).astype(np.uint8)).cuda() for w in widths)
    lx, ly = (torch.as_tensor(g.integers(1, w + 1, 8).astype(np.int32)).cuda() for w in widths)
    scores = tsk.exact_match_scores(x, lx, y, ly, gap)
    calls = _kernel_calls()
    got = tsk.gap_weighted_string_kernel(scores, gap)
    torch.cuda.synchronize()
    assert _kernel_calls() == calls + 1
    want = tsk.gap_weighted_string_kernel_reference(scores, gap)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    assert torch.equal(tsk.gap_weighted_string_kernel(scores[1:2].contiguous(), gap), got[1:2])


@pytest.mark.cuda
def test_cuda_kernel_values_do_not_depend_on_the_batch():
    """A pair's bits alone, at batch 256, at another position and padded
    wider."""
    _cuda_or_skip()
    kern = tsk.StringKernel(0.8, alpha=0.2).cuda()
    case = _cuda_case(21, 256, (150, 150))
    got = kern(*case)
    for k in (0, 1, 255):
        assert torch.equal(kern(*[t[k:k + 1].contiguous() for t in case]), got[k:k + 1])
    assert torch.equal(kern(*[torch.roll(t, 1, 0).contiguous() for t in case]),
                       torch.roll(got, 1))
    wide = [torch.nn.functional.pad(t, (0, 0, 0, 40) if t.dim() == 3 else (0, 40))
            if t.dim() > 1 else t for t in case]
    assert torch.equal(kern(*wide), got)
