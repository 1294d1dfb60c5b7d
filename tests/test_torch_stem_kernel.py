"""Port parity: DAG closures, the closure fixed point and the stem kernel.

The same numpy inputs go through the JAX package (the reference) and the
PyTorch port; the port runs its plain torch versions here (CPU tensors).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.io.profile import Alignment as JAlignment
from stem_kernel_tpu.models import dag as jdag
from stem_kernel_tpu.models import stem_kernel as jsk
from stem_kernel_tpu.models.composite import StemLiteConfig as JConfig
from stem_kernel_tpu.models.composite import featurize_stem_examples as j_featurize
from stem_kernel_tpu.ops.pallas_stem import stem_fixed_point as j_fixed_point
from stem_kernel_torch.fold.bpmatrix import fold_sequences
from stem_kernel_torch.models import dag as tdag
from stem_kernel_torch.models import stem_kernel as tsk
from stem_kernel_torch.ops.stem_fixed_point import (
    stem_fixed_point,
    stem_fixed_point_reference,
)

from stem_oracle import stem_kernel_ref

SEQS = [
    "gggaaaccc",
    "gcgcaaagcgc",
    "ggcaaagccaugcaaaagcau",
    "gggcuauuagcucaguggua",
    "gggcgcaagcuugaaagcgcccauaggcuaacgu",
]
GAP = 0.2


def _dags(seqs, th=0.01):
    """JAX-package DAGs (host numpy) from the port's fold of the rows."""
    bpps = fold_sequences(seqs, device="cpu")
    return [jdag.build_dag(JAlignment(rows=[s]), b, [b], th=th) for s, b in zip(seqs, bpps)]


def _stacked_ops(dags, n_pad):
    ops = [jdag.dag_operators(d, GAP, n_pad) for d in dags]
    return {k: np.stack([o[k] for o in ops]) for k in ops[0]}


def _features(dags, n_pad):
    """Closure-solved features: numpy (from JAX) and torch (from the port)."""
    stacked = _stacked_ops(dags, n_pad)
    return jdag.closure_features(stacked), tdag.closure_features(stacked, "cpu")


def _to_jax(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def test_closure_features_match_jax():
    dags = _dags(SEQS)
    n_pad = 16 * -(-max(d.n_nodes for d in dags) // 16)
    j, t = _features(dags, n_pad)
    assert set(j) == set(t)
    for key in ("V", "u"):
        np.testing.assert_allclose(t[key].numpy(), j[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for key in ("A", "leaf", "r", "bp_freq", "gap2w", "depth"):
        np.testing.assert_array_equal(t[key].numpy(), j[key], err_msg=key)


def _pair_operands(trips: str):
    """Fixed-point operands on real DAG features, as the JAX test builds them
    (tests/test_stem_kernel.py:test_pallas_fixed_point_matches_einsum_path)."""
    cfg = JConfig(no_string=True, node_pad_multiple=8)
    feats, iters = j_featurize([JAlignment(rows=[s]) for s in SEQS[:4]], cfg)
    ix = np.array([0, 1, 2, 3, 0, 2], np.int64)
    iy = np.array([1, 2, 3, 0, 3, 1], np.int64)
    x = {k: torch.as_tensor(np.asarray(v)[ix]) for k, v in feats.items()}
    y = {k: torch.as_tensor(np.asarray(v)[iy]) for k, v in feats.items()}
    co = torch.as_tensor(jsk.subst_co_table(cfg.beta))
    ops = tsk.fixed_point_operands(x, y, co, iters=iters, len_band=cfg.len_band)
    if trips == "full":
        ops = ops[:-1] + (torch.full((len(ix),), iters, dtype=torch.int32),)
    return ops, iters


@pytest.mark.parametrize("trips", ["per_pair", "full"])
def test_fixed_point_reference_matches_pallas_interpret(trips):
    ops, iters = _pair_operands(trips)
    want = np.asarray(j_fixed_point(*[jnp.asarray(o.numpy()) for o in ops],
                                    max_iters=iters, interpret=True))
    got = stem_fixed_point_reference(*ops, max_iters=iters).numpy()
    # f32 products summed in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(stem_fixed_point(*ops, max_iters=iters).numpy(), got)


@pytest.mark.parametrize("table,len_band", [("subst", 0), ("subst", 10), ("simple", 3)])
def test_stem_kernel_pairs_match_jax_and_oracle(table, len_band):
    co = jsk.subst_co_table(0.3) if table == "subst" else jsk.simple_co_table(1.3, 0.8)
    dags = _dags(SEQS)
    n_pad = max(d.n_nodes for d in dags)
    iters = max(d.depth for d in dags) + 1
    j, t = _features(dags, n_pad)
    ix, iy = np.triu_indices(len(dags))
    jx = _to_jax({k: v[ix] for k, v in j.items()})
    jy = _to_jax({k: v[iy] for k, v in j.items()})
    want = np.asarray(jsk.stem_kernel_pairs(jx, jy, jnp.asarray(co), iters=iters,
                                            len_band=len_band, precision="highest",
                                            force_xla=True))
    tx = {k: v[torch.as_tensor(ix)] for k, v in t.items()}
    ty = {k: v[torch.as_tensor(iy)] for k, v in t.items()}
    got = tsk.stem_kernel_pairs(tx, ty, torch.as_tensor(co), iters=iters,
                                len_band=len_band).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    oracle = np.array([stem_kernel_ref(dags[a], dags[b], co, GAP, len_band=len_band)
                       for a, b in zip(ix, iy)])
    # f32 port against the f64 cell-by-cell recursion
    np.testing.assert_allclose(got, oracle, rtol=1e-5)


def test_stem_kernel_rectangular_pairs_match_jax():
    """Pairs across two node buckets (Nx != Ny), as bucketed Gram blocks run."""
    small, large = _dags(SEQS[:2]), _dags(SEQS[2:])
    js, ts = _features(small, 16)
    jl, tl = _features(large, 32)
    iters = max(d.depth for d in small + large) + 1
    ix = np.array([0, 1, 0, 1, 1])
    iy = np.array([0, 1, 2, 2, 0])
    kern_j = jsk.StemKernel(loop_gap=GAP, beta=0.3, len_band=10)
    kern_t = tsk.StemKernel(loop_gap=GAP, beta=0.3, len_band=10)
    want = np.asarray(jsk.stem_kernel_pairs(
        _to_jax({k: v[ix] for k, v in js.items()}), _to_jax({k: v[iy] for k, v in jl.items()}),
        kern_j.co_table, iters=iters, len_band=10, force_xla=True))
    got = kern_t({k: v[torch.as_tensor(ix)] for k, v in ts.items()},
                 {k: v[torch.as_tensor(iy)] for k, v in tl.items()}, iters=iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _bad(ops, i, value):
    return ops[:i] + (value,) + ops[i + 1:]


@pytest.mark.parametrize("case", ["dtype", "shape", "noncontig", "iters_dtype", "precision"])
def test_fixed_point_wrapper_rejects_bad_operands(case):
    ops, iters = _pair_operands("per_pair")
    kwargs = {"max_iters": iters}
    if case == "dtype":
        ops = _bad(ops, 1, ops[1].double())
    elif case == "shape":
        ops = _bad(ops, 6, ops[6][:, :-1].contiguous())
    elif case == "noncontig":
        ops = _bad(ops, 3, ops[3].transpose(1, 2))
    elif case == "iters_dtype":
        ops = _bad(ops, 8, ops[8].long())
    else:
        kwargs["precision"] = "bf16"
    with pytest.raises(ValueError):
        stem_fixed_point(*ops, **kwargs)


def test_convert_carries_tables_across():
    from stem_kernel_tpu.fold.params import default_params as j_default_params
    from stem_kernel_tpu.models.string_kernel import StringKernel as JString
    from stem_kernel_torch.convert import energy_params_from_numpy, stem_lite_modules_from_numpy
    from stem_kernel_torch.fold.params import default_params as t_default_params

    j_stem = jsk.StemKernel(loop_gap=GAP, beta=0.3, len_band=10)
    j_string = JString(0.8, alpha=0.2)
    stem, string = stem_lite_modules_from_numpy(
        np.asarray(j_stem.co_table), np.asarray(j_string.subst), "cpu")
    np.testing.assert_array_equal(stem.co_table.numpy(), np.asarray(j_stem.co_table))
    np.testing.assert_array_equal(string.subst.numpy(), np.asarray(j_string.subst))
    params = energy_params_from_numpy(dataclasses.asdict(j_default_params()))
    ref = t_default_params()
    for f in dataclasses.fields(ref):
        a, b = getattr(params, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card,
    square and rectangular (Nx != Ny) operands, per-pair trip counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    ops, iters = _pair_operands("per_pair")
    dev = [o.cuda() for o in ops]
    got = stem_fixed_point(*dev, max_iters=iters)
    torch.cuda.synchronize()
    want = stem_fixed_point_reference(*dev, max_iters=iters)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    bsz, nx, ny = 7, 40, 72
    mats = [torch.rand(bsz, *s, generator=g) * 0.05
            for s in [(nx, ny), (nx, nx), (ny, ny), (nx, nx), (ny, ny), (nx, ny)]]
    vecs = [torch.rand(bsz, nx, generator=g), torch.rand(bsz, ny, generator=g)]
    trips = torch.tensor([0, 1, 2, 3, 4, 5, 5], dtype=torch.int32)
    args = [t.cuda() for t in mats + vecs + [trips]]
    got = stem_fixed_point(*args, max_iters=5).cpu().numpy()
    want = stem_fixed_point_reference(*args, max_iters=5).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[0] == 0.0
