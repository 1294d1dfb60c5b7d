"""The closure fixed point's product modes (K1 on the card: f32, 3xTF32, bf16).

The precision names map onto modes (``stem_kernel_torch.ops.stem_fixed_point.
MODES``); the plain version rounds each product's operands as the kernel
does.  Here: the rounding helpers against numpy bit-level references, the
3xTF32 split, the plain version in each mode against the JAX package on
real DAG features (square per-pair trips, and a rectangular Nx != Ny
batch) and on random operands past 128 nodes (the per-product route's
shapes, Nx < Ny and Nx > Ny), the CPU wrapper's f32 for every name, the
route table (every route runs the mode its name maps to), and the kernel
on the card against the plain version in the same mode (skipped without a
card).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stem_kernel_tpu.models import stem_kernel as jsk
from stem_kernel_tpu.ops.pallas_stem import stem_fixed_point as j_fixed_point
from stem_kernel_torch.models import stem_kernel as tsk
from stem_kernel_torch.ops import stem_fixed_point as fp
from stem_kernel_torch.utils.tracing import counters

from test_torch_stem_kernel import SEQS, _dags, _features, _pair_operands, _to_jax


def _np_round(x: np.ndarray, mantissa: int, ties_even: bool) -> np.ndarray:
    """f32 rounded to ``mantissa`` explicit bits by float64 arithmetic (no
    bit tricks): the spacing is 2^(E - mantissa) with E = max(exponent, -126),
    so subnormals keep the f32 exponent floor."""
    x64 = x.astype(np.float64)
    out = x64.copy()
    fin = np.isfinite(x64) & (x64 != 0)
    _, e = np.frexp(np.abs(x64[fin]))  # |x| = m 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, np.maximum(e - 1, -126) - mantissa)
    q = np.abs(x64[fin]) / ulp  # exact: a power-of-two scale
    q = np.rint(q) if ties_even else np.floor(q + 0.5)
    out[fin] = np.sign(x64[fin]) * q * ulp
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _edge_values(rng: np.random.Generator, drop_bits: int) -> np.ndarray:
    """Random f32 over the whole exponent range, exact ties at the rounding
    bit (both signs, odd and even kept parts), subnormals, zeros, the
    largest finite values (which round to inf) and inf."""
    bits = rng.integers(0, 0x7F800000, 4000, dtype=np.int64)
    half = 1 << (drop_bits - 1)
    ties = (rng.integers(0, 0x7F800000 >> drop_bits, 1000, dtype=np.int64) << drop_bits) | half
    sub = rng.integers(1, 1 << 23, 1000, dtype=np.int64)  # exponent 0
    sub_ties = ((rng.integers(0, (1 << 23) >> drop_bits, 200, dtype=np.int64) << drop_bits)
                | half)
    special = np.array([0, 0x7F7FFFFF, 0x7F7FF000, 0x7F800000, 1, half, half - 1],
                       dtype=np.int64)
    allb = np.concatenate([bits, ties, sub, sub_ties, special])
    signs = rng.integers(0, 2, allb.size, dtype=np.int64) << 31
    return (allb | signs).astype(np.uint32).view(np.float32)


def test_round_tf32_matches_numpy_bits():
    x = _edge_values(np.random.default_rng(40), 13)
    got = fp.round_tf32(torch.as_tensor(x)).numpy()
    want = _np_round(x, 10, ties_even=False)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()


def test_round_bf16_matches_numpy_bits():
    x = _edge_values(np.random.default_rng(41), 16)
    got = fp.round_bf16(torch.as_tensor(x)).numpy()
    want = _np_round(x, 7, ties_even=True)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_split_tf32_reconstructs():
    """hi + lo gives x within 2^-22 relative, both parts TF32 (low 13 bits 0)."""
    rng = np.random.default_rng(42)
    x = (rng.uniform(1, 2, 100_000) * 2.0 ** rng.integers(-100, 100, 100_000)
         * rng.choice([-1.0, 1.0], 100_000)).astype(np.float32)
    hi, lo = fp.split_tf32(torch.as_tensor(x))
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    rec = hi.double() + lo.double()
    rel = ((rec - torch.as_tensor(x).double()).abs() / torch.as_tensor(x).double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def _k1_calls() -> tuple[int, int]:
    """K1's launches as the program counts them: (cluster route, per-product route)."""
    c = counters()
    return c.get("k1.calls.cluster", 0), c.get("k1.calls.tiles", 0)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float((np.abs(got - want) / np.abs(want)).max())


def _wide_case(nx: int, ny: int):
    """Random operands past 128 nodes, B = 2 with per-pair trips (2, 3),
    scaled as chip_smoke's k1_random so the fixed point stays bounded; and
    the same operands zero-padded to a square max(Nx, Ny), which the JAX
    kernel takes (it pads to n_pad 256 itself; zero nodes leave M alone)."""
    rng = np.random.default_rng(nx * 1000 + ny)
    f32 = np.float32
    ops = [rng.random((2, nx, ny), f32), rng.random((2, nx, nx), f32) * f32(1.5 / nx),
           rng.random((2, ny, ny), f32) * f32(1.5 / ny),
           rng.random((2, nx, nx), f32) * f32(1.5 / nx),
           rng.random((2, ny, ny), f32) * f32(1.5 / ny), rng.random((2, nx, ny), f32),
           rng.random((2, nx), f32), rng.random((2, ny), f32)]
    n = max(nx, ny)
    square = [np.pad(o, [(0, 0)] + [(0, n - d) for d in o.shape[1:]]) for o in ops]
    iters = np.array([2, 3], np.int32)
    return ([torch.as_tensor(o) for o in ops] + [torch.as_tensor(iters)],
            [jnp.asarray(o) for o in square] + [jnp.asarray(iters)], 3)


def _jax_per_pair(jops: list, iters: int, precision: str) -> np.ndarray:
    """The JAX kernel one pair a call: it runs a block of pairs for the
    block's largest trip count (no-ops on DAG features, whose fixed point
    is stable past its depth, but not on random operands), so alone each
    pair keeps its own trips."""
    return np.concatenate([np.asarray(j_fixed_point(
        *[o[b:b + 1] for o in jops], max_iters=iters, precision=precision, interpret=True))
        for b in range(jops[0].shape[0])])


_WIDE = {"144x160": (144, 160), "160x144": (160, 144)}


@pytest.mark.parametrize("case", ["corpus", *_WIDE])
def test_bf16_mode_matches_pallas_default(case):
    """The plain version in bf16 against the JAX kernel's one-pass bf16
    ``dot_bf`` (interpret mode): both round the operands of every product to
    bf16 and sum in f32.  They agree within 1e-5 relative (8.1e-8 measured
    on the corpus), while bf16 moves the value 1.4e-3 from f32 there: the
    plain version must sit at least 10x nearer the JAX kernel than the f32
    value does, so a version that skips or halves the rounding fails.  Past
    128 nodes (the per-product route's shapes) on random operands too."""
    if case == "corpus":
        ops, iters = _pair_operands("per_pair")
        want = np.asarray(j_fixed_point(*[jnp.asarray(o.numpy()) for o in ops],
                                        max_iters=iters, precision="default", interpret=True))
    else:
        ops, jops, iters = _wide_case(*_WIDE[case])
        want = _jax_per_pair(jops, iters, "default")
    got = fp.stem_fixed_point_reference(*ops, max_iters=iters, mode="bf16").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    f32 = fp.stem_fixed_point_reference(*ops, max_iters=iters).numpy()
    assert _rel(f32, want) >= 10 * max(_rel(got, want), 1e-6)


def _rect_case():
    """A rectangular batch (Nx = 16, Ny = 32) on real DAG features with
    per-pair trips, and the JAX XLA path's values at "highest" for it."""
    small, large = _dags(SEQS[:2]), _dags(SEQS[2:])
    js, ts = _features(small, 16)
    jl, tl = _features(large, 32)
    iters = max(d.depth for d in small + large) + 1
    ix = np.array([0, 1, 0, 1, 1])
    iy = np.array([0, 1, 2, 2, 0])
    co = jsk.subst_co_table(0.3)
    want = np.asarray(jsk.stem_kernel_pairs(
        _to_jax({k: v[ix] for k, v in js.items()}), _to_jax({k: v[iy] for k, v in jl.items()}),
        jnp.asarray(co), iters=iters, len_band=10, precision="highest", force_xla=True))
    x = {k: v[torch.as_tensor(ix)] for k, v in ts.items()}
    y = {k: v[torch.as_tensor(iy)] for k, v in tl.items()}
    ops = tsk.fixed_point_operands(x, y, torch.as_tensor(co), iters=iters, len_band=10)
    leaf = ((x["u"] * x["leaf"]).sum(-1) * (y["r"] * y["leaf"]).sum(-1)).numpy()
    return ops, iters, want - leaf


@pytest.mark.parametrize("mode", ["f32", "3xtf32"])
@pytest.mark.parametrize("shape", ["square", "rectangular", *_WIDE])
def test_f32_modes_match_jax_highest(mode, shape):
    """f32 and 3xTF32 against JAX "highest" (full f32) within 1e-4 rel:
    the Pallas kernel in interpret mode (square, and random operands past
    128 nodes, zero-padded square for it) or the XLA loop (Nx != Ny)."""
    if shape == "square":
        ops, iters = _pair_operands("per_pair")
        want = np.asarray(j_fixed_point(*[jnp.asarray(o.numpy()) for o in ops],
                                        max_iters=iters, precision="highest", interpret=True))
    elif shape in _WIDE:
        ops, jops, iters = _wide_case(*_WIDE[shape])
        want = _jax_per_pair(jops, iters, "highest")
    else:
        ops, iters, want = _rect_case()
    assert len(set(ops[-1].tolist())) > 1  # per-pair trip counts
    got = fp.stem_fixed_point_reference(*ops, max_iters=iters, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_wrapper_runs_f32_for_every_name(precision):
    ops, iters = _pair_operands("per_pair")
    before = _k1_calls()
    got = fp.stem_fixed_point(*ops, max_iters=iters, precision=precision).numpy()
    want = fp.stem_fixed_point_reference(*ops, max_iters=iters, mode="f32").numpy()
    assert np.array_equal(got, want)
    assert _k1_calls() == before


def test_modes_and_routes():
    """The cut-over the card's times placed (chip_smoke.py phase 5), the same
    in every mode: the cluster kernel up to 64 nodes (one CTA a pair), the
    per-product route's tile kernel past it, at 64 x 128 and 128 x 128 too."""
    assert fp.MODES == {"highest": "f32", "high": "3xtf32", "default": "bf16"}
    assert fp.cluster_route(64, 64) and fp.cluster_route(1, 64)
    assert fp.cluster_route(60, 16) and fp.cluster_route(16, 49)
    assert not fp.cluster_route(65, 64)  # 80 nodes once padded
    assert not fp.cluster_route(64, 128) and not fp.cluster_route(20, 100)
    assert not fp.cluster_route(128, 128) and not fp.cluster_route(120, 16)
    assert not fp.cluster_route(129, 64)
    assert not fp.cluster_route(64, 144)
    assert not fp.cluster_route(256, 256)
    with pytest.raises(ValueError):
        fp.stem_fixed_point_reference(*_pair_operands("full")[0], max_iters=2, mode="tf32")


class _FakeLibrary:
    """Stands in for the built CUDA library: records the route and the mode
    id (argument 12 of both launch entry points) of each launch, and the
    tile kernel's geometry (arguments 13-18: rows tile, strip columns, CTAs
    a pair, stages, spill, release lag) and scratch pointers (19-26)."""

    def __init__(self):
        self.calls = []
        self.tiles = []

    def stem_fixed_point_cluster(self, *args):
        self.calls.append(("cluster", args[12]))
        return 0

    def stem_fixed_point_tiles(self, *args):
        self.calls.append(("per-product", args[12]))
        self.tiles.append((args[10], args[11], args[13:19], args[19:27]))
        return 0


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_route_runs_the_named_mode(precision, monkeypatch):
    """Each route the wrapper picks passes the library the mode id its name
    maps to (the C interface's 0 f32, 1 3xTF32, 2 bf16), on both sides of
    the cut-over and past 128 nodes, Nx < Ny and Nx > Ny: the launch
    functions run on CPU tensors against a stand-in for the built library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fp, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    want = {"highest": 0, "high": 1, "default": 2}[precision]
    shapes = {(16, 16): "cluster", (64, 48): "cluster", (40, 64): "cluster",
              (64, 80): "per-product", (128, 128): "per-product", (144, 160): "per-product",
              (160, 144): "per-product", (320, 288): "per-product", (64, 256): "per-product",
              (512, 512): "per-product"}
    for (nx, ny), name in shapes.items():
        ops = [torch.zeros(shape) for shape in ((1, nx, ny), (1, nx, nx), (1, ny, ny),
                                                (1, nx, nx), (1, ny, ny), (1, nx, ny),
                                                (1, nx), (1, ny))]
        iters = torch.ones(1, dtype=torch.int32)
        launch = fp.cluster_kernel if fp.cluster_route(nx, ny) else fp.per_product_route
        launch(*ops, iters, precision=precision)
        assert lib.calls[-1] == (name, want), (nx, ny)
    assert len(lib.calls) == len(shapes)
    # the tile kernel gets tile_geometry's choice for the padded shape, the
    # operands' scratch in the mode's form (none in f32, which reads them as
    # they are) and a spill buffer only where the strip spills
    assert len(lib.tiles) == sum(name == "per-product" for name in shapes.values())
    for px, py, geometry, scratch in lib.tiles:
        geo = fp.tile_geometry(px, py, precision)
        assert geometry == (geo["rows"], geo["strip"], geo["ctas"], geo["stages"],
                            int(geo["spill"]), int(geo["lag"]))
        converted = scratch[:4]
        assert all(ptr is None for ptr in converted) == (precision == "highest")
        assert (scratch[7] is not None) == geo["spill"]
        assert all(ptr is not None for ptr in scratch[4:7])  # M, G2, f32 M


def _form(x: torch.Tensor, mode: str) -> tuple[torch.Tensor, ...]:
    """x in the mode's form, as the tile kernel stores it: (x,) in f32,
    (hi, lo) in 3xTF32, (x rounded to bf16,) in bf16."""
    if mode == "3xtf32":
        return fp.split_tf32(x)
    return (fp.round_bf16(x),) if mode == "bf16" else (x,)


def _bmm_form(a: tuple, b: tuple, mode: str) -> torch.Tensor:
    """a @ b from operands already in the mode's form: the plain version's
    products and sums, in its order."""
    if mode == "3xtf32":
        (ah, al), (bh, bl) = a, b
        return (torch.bmm(al, bh) + torch.bmm(ah, bl)) + torch.bmm(ah, bh)
    return torch.bmm(a[0], b[0])


def _converted_flow(ns, vx, vy, ax, ay, l, ux, uy, iters, *, max_iters, mode):
    """The tile kernel's data flow in plain torch: Vx, Ax, Vy and Ay put in
    the mode's form once a call, and M, G2 and the strip S put in it where
    they are written, so no product converts an operand; the bilinear form
    reads M in f32."""
    it = torch.clamp(iters, max=max_iters)
    cvx, cax = _form(vx, mode), _form(ax, mode)
    cvyt = tuple(t.transpose(1, 2) for t in _form(vy, mode))
    cayt = tuple(t.transpose(1, 2) for t in _form(ay, mode))
    m = torch.zeros_like(ns)
    cm = _form(m, mode)
    for k in range(max_iters):
        s = _bmm_form(cm, cvyt, mode) + l  # the first half-trip's strip
        g2 = _bmm_form(cvx, _form(s, mode), mode)  # written in the mode's form
        m_new = ns * _bmm_form(cax, _form(_bmm_form(_form(g2, mode), cayt, mode), mode), mode)
        m = torch.where((it > k)[:, None, None], m_new, m)
        cm = _form(m, mode)
    return torch.einsum("bi,bij,bj->b", ux, m, uy)


@pytest.mark.parametrize("mode", ["f32", "3xtf32", "bf16"])
@pytest.mark.parametrize("case", ["corpus", *_WIDE])
def test_converted_flow_matches_reference(mode, case):
    """The tile kernel's data flow in plain torch (Vx, Ax, Vy, Ay in the
    mode's form once a call; M, G2 and the strip where they are written)
    gives the per-product plain version's values bit for bit in every mode:
    a value rounded once and rounded each trip round alike."""
    if case == "corpus":
        ops, iters = _pair_operands("per_pair")
    else:
        ops, _, iters = _wide_case(*_WIDE[case])
    want = fp.stem_fixed_point_reference(*ops, max_iters=iters, mode=mode).numpy()
    got = _converted_flow(*ops, max_iters=iters, mode=mode).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tile_geometry():
    """The tile kernel's geometry, chosen in one place (tile_geometry): a
    64-row tile at Nx <= 64 (so at Nx = 64 no warp idles) and 128 rows past
    it, one CTA a strip (64 columns; 128 in bf16 on the 64-row tile) up to
    8 a pair, the
    strip spilled where shared memory would leave fewer than 3 stages, a
    stage released a chunk late only in rings of more than 4 stages (the
    card's times chose each rule), and the shared-memory bytes within a
    CTA's."""
    g = fp.tile_geometry
    assert g(64, 256)["rows"] == 64 and g(64, 128)["rows"] == 64
    assert g(128, 256)["rows"] == 128 and g(112, 48)["rows"] == 128
    assert g(48, 256)["rows"] == 64 and g(80, 128)["rows"] == 128
    assert g(192, 192)["rows"] == 128 and g(320, 288)["rows"] == 128
    assert [g(64, ny)["ctas"] for ny in (48, 64, 128, 256, 512, 1024)] == [1, 1, 2, 4, 8, 8]
    assert g(80, 176)["nstrips"] == 3 and g(80, 176)["ctas"] == 3
    # 128-column strips in bf16 on the 64-row tile only
    assert g(64, 512, "default")["strip"] == 128 and g(64, 512, "default")["ctas"] == 4
    assert g(64, 512, "high")["strip"] == 64 and g(64, 512, "highest")["strip"] == 64
    assert g(128, 512, "default")["strip"] == 64
    assert not g(128, 256, "high")["spill"] and g(256, 256, "high")["spill"]
    assert g(512, 512, "high")["spill"] and g(320, 288, "high")["spill"]
    assert g(528, 96, "high")["spill"] and g(1056, 96, "highest")["spill"]
    for prec in ("highest", "default"):
        assert not g(256, 256, prec)["spill"] and not g(512, 512, prec)["spill"]
    assert not g(528, 96, "default")["spill"] and not g(1216, 96, "default")["spill"]
    # 1232 x 96: the first Nx at which the strip spills in every mode
    assert all(g(1232, 96, prec)["spill"] for prec in fp.PRECISIONS)
    for nx, ny in ((64, 128), (128, 128), (64, 256), (128, 256), (256, 256), (128, 512),
                   (512, 512), (320, 288), (528, 96), (1056, 96), (1232, 96)):
        for prec in fp.PRECISIONS:
            geo = g(nx, ny, prec)
            assert 2 <= geo["stages"] <= fp.MAX_TILE_STAGES
            assert geo["smem_bytes"] <= fp.SMEM_LIMIT
            assert geo["lag"] == (geo["stages"] > 4)
            if not geo["spill"] and geo["stages"] < fp.MAX_TILE_STAGES:
                assert fp.tile_smem(nx, fp.MODES[prec], geo["rows"], geo["stages"] + 1,
                                    False, geo["strip"]) > fp.SMEM_LIMIT  # as many as fit


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("shape", [(64, 64), (128, 64), (64, 128), (40, 72), (128, 256),
                                   (320, 288), (64, 256), (512, 512)],
                         ids=["C=1", "rect C=4", "64x128", "padded", "per-product 128x256",
                              "per-product 320x288", "per-product 64x256",
                              "per-product 512x512"])
def test_cuda_modes_match_plain_version(precision, shape):
    """The kernel in each mode against the plain version in the same mode,
    on random operands scaled so the fixed point stays bounded, with
    per-pair trips (0 included), on the route ``cluster_route`` picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    nx, ny = shape
    g = torch.Generator().manual_seed(nx + ny)
    bsz = 6
    mats = [torch.rand(bsz, nx, ny, generator=g), torch.rand(bsz, nx, nx, generator=g) * 1.5 / nx,
            torch.rand(bsz, ny, ny, generator=g) * 1.5 / ny,
            torch.rand(bsz, nx, nx, generator=g) * 1.5 / nx,
            torch.rand(bsz, ny, ny, generator=g) * 1.5 / ny, torch.rand(bsz, nx, ny, generator=g)]
    vecs = [torch.rand(bsz, nx, generator=g), torch.rand(bsz, ny, generator=g)]
    trips = torch.tensor([0, 1, 2, 3, 5, 6], dtype=torch.int32)
    args = [t.cuda() for t in mats + vecs + [trips]]
    wide = not fp.cluster_route(nx, ny)
    before = _k1_calls()[wide]
    got = fp.stem_fixed_point(*args, max_iters=6, precision=precision).cpu().numpy()
    torch.cuda.synchronize()
    after = _k1_calls()[wide]
    assert after == before + 1
    mode = fp.MODES[precision]
    want = fp.stem_fixed_point_reference(*args, max_iters=6, mode=mode).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)  # f32 sums in another order
    assert got[0] == 0.0
    if mode == "bf16":  # the kernel rounds: 10x nearer plain bf16 than plain f32
        f32 = fp.stem_fixed_point_reference(*args, max_iters=6).cpu().numpy()
        assert _rel(got[1:], f32[1:]) >= 10 * _rel(got[1:], want[1:])
