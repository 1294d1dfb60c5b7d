"""How the arithmetic of the log LA kernels moves log K, in plain torch.

    python3 la_log_numerics.py [--device cuda|cpu] [--lengths 256,400,512,700]
                               [--pairs 128]

Evaluates K2's plain version (``stem_kernel_torch.ops.la``, the
row-rescaled log closure) with one change at a time, each a plain-torch
model of a step of the lane kernels (``csrc/la_dp.cu``, ``la_log_lanes``),
and prints, for each length and change, the largest and the mean difference
in log K from the plain version on the same inputs:

- ``exp2``: exp(m - r) as 2^((m - r) log2 e), the product rounded to f32;
- ``exp_sub``: the same product carried in two floats, as ``exp_sub`` does;
- ``softplus3``: softplus(logaddexp(a, bg g)) as one log of a three-term
  sum under its largest term;
- ``log2``: every natural log as ln 2 log2(x), and the exps of logaddexp
  as 2^(x log2 e) with the product rounded to f32;
- ``exp_sub+softplus3+log2``: the three together, the lane kernels' arithmetic;
- ``flush``: exp(m - r) flushed to zero below the smallest normal f32;
- ``f64``: the whole closure in f64, with the same floor TINY.

2^x and log2 are torch's, so the SFU's own error (about 2 units in the last
place) is not modelled.  Inputs: ``chip_smoke.py``'s random BPLA profiles,
all pairs at the full length, K2's factors, ``bpla_kernel``'s parameters.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import chip_smoke as cs
from stem_kernel_torch.models.bpla import BPLAKernel
from stem_kernel_torch.ops import la

L2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453
VARIANTS = ("exp2", "exp_sub", "softplus3", "log2", "exp_sub+softplus3+log2", "flush", "f64")


def log_closure(emit_row, lx, ly, nx: int, ny: int, sc: dict, variant: str = "") -> torch.Tensor:
    """la._log_dp with the changes of ``variant`` ("+"-joined) applied; ""
    is the plain version."""
    parts = set(variant.split("+"))
    dt = torch.float64 if "f64" in parts else torch.float32
    log2 = "log2" in parts
    log = (lambda t: LN2 * torch.log2(t)) if log2 else torch.log
    exp = (lambda t: torch.exp2(t * L2E)) if log2 else torch.exp

    def lae(x, y):  # logaddexp
        hi, lo = torch.maximum(x, y), torch.minimum(x, y)
        return hi + log(1 + exp(lo - hi)) if log2 else torch.logaddexp(x, y)

    rows, cols = la._masks(lx, ly, nx, ny)
    bsz, dev = lx.shape[0], lx.device
    tu = la.u_closure_matrix(sc["lbg"], sc["lbe"], ny, device=dev).to(dt)
    neg, zero = torch.full((), la.NEG, dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev)
    a = torch.full((bsz, ny), la.NEG, dtype=dt, device=dev)
    g = torch.full_like(a, la.NEG)
    acc = torch.full((bsz,), la.NEG, dtype=dt, device=dev)
    for i in range(nx):
        mask = cols & rows[:, i:i + 1]
        le = torch.where(mask, emit_row(i).to(dt), neg)
        if "softplus3" in parts:
            x, y = a, sc["lbg"] + g
            hi, lo = torch.maximum(x, y), torch.minimum(x, y)
            h, o = torch.clamp(hi, min=0.0), torch.clamp(hi, max=0.0)
            m = le + (h + log(1 + exp(o - h) + exp(lo - h)))
        else:
            m = le + lae(zero, lae(a, sc["lbg"] + g))
        r = m.amax(1, keepdim=True)
        x = m - r
        if "exp2" in parts:
            em = torch.exp2(x * L2E)
        elif "exp_sub" in parts:
            t = x * L2E
            d = (x.double() * L2E - t.double()).float()  # what rounding t dropped
            y = torch.exp2(t).double()
            em = (y * (d * LN2).double() + y).float()  # one rounding, as fmaf
        else:
            em = torch.exp(x)
        if "flush" in parts:
            em = torch.where(em < la.TINY, zero, em)
        av = torch.bmm(em[:, None, :], tu.expand(bsz, *tu.shape))[:, 0]
        g = lae(sc["lbe"] + g, a)
        a = torch.where(av >= la.TINY, r + log(av), neg)
        acc = lae(acc, r[:, 0] + log(torch.clamp(em.sum(1), min=la.TINY)))
    return lae(zero, acc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--lengths", default="256,400,512,700")
    ap.add_argument("--pairs", type=int, default=128)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("la_log_numerics: no CUDA device; pass --device cpu")
    dev = torch.device(args.device)
    kern = BPLAKernel().to(dev)
    sc = la._scalars(*cs.BPLA[1:])
    rng = np.random.default_rng(cs.SEED)
    for n in (int(v) for v in args.lengths.split(",")):
        feats = cs.pick(cs.random_profiles(rng, args.pairs, n, n), np.arange(args.pairs), dev)
        fx, fy = kern.factors(feats, "x"), kern.factors(feats, "y")
        lx = ly = feats["length"]
        emit = la._factored_emitter(fx, fy, cs.BPLA[0], sc)
        plain = log_closure(emit, lx, ly, n, n, sc)
        if not torch.equal(plain, la.la_log_factored_reference(fx, fy, lx, ly, *cs.BPLA)):
            raise SystemExit("la_log_numerics: the unchanged closure is not the plain version")
        cols = []
        for v in VARIANTS:
            diff = log_closure(emit, lx, ly, n, n, sc, v).double() - plain.double()
            cols.append(f"{v} {float(diff.abs().max()):.2e} (mean {float(diff.mean()):+.2e})")
        print(f"L={n}, {args.pairs} pairs, log K {float(plain.min()):.1f}.."
              f"{float(plain.max()):.1f}; largest (mean) difference from the plain version: "
              + "; ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
