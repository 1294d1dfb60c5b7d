// Scaled McCaskill fold DP on Hopper (sm_90a), full f32: the inside pass,
// the exterior and outside-exterior chains, and the outside pass of every
// sequence of a fold batch in one launch, one thread block a sequence.
//
// Replaces no Pallas kernel.  The JAX package folds with the lax.scan code
// of stem_kernel_tpu/fold/mccaskill_scaled.py, which XLA compiles into one
// program on the TPU.  The port's plain version (fold/mccaskill_scaled.py,
// _inside_scaled and _outside_scaled) writes each scan as a Python loop over
// the span length: about 150 small torch ops a span and pass, some 40,000
// launches for a batch of 200 sequences of 130 nt, while the card idles.
// The LUTs stay in torch (tables.build_luts); this kernel reads them.
//
// The recursions are the plain version's, term for term, at its scale
// points and clamps.  Row d (span length d) of the inside pass, lanes i with
// i + d < L (the sequence's length):
//
//   p    = max(mu[t-1] + mu[d-t], mu[d-t] over t; log hairpin[d][i] over i),
//          0 when below -1e29
//   Qb   = wpair * (exp(hairpin - p) + stack Qb[d-2][i+1] f[2]
//          + explicit small loops + sum over loop classes c of
//          cls_out_c * sum_(a,b) exp(pen) Qb_c[d-a-b][i+a] f[a+b]
//          + ml_close Qm2[d-2][i+1] f[2]),     f[t] = exp(mu[d-t] - p)
//   Qm1  = c Qm1[d-1][i] f[1] + ml_stem Qb
//   Qm2  = sum_t Qm[t-1][i] Qm1[d-t][i+t] exp(mu[t-1] + mu[d-t] - p)
//   Qm   = Qm2 + Qm1 + sum_t Qm1[d-t][i+t] c^t f[t]
//
// then one rescale of the four rows by their joint maximum m (mu[d] = p +
// log m).  Qb_c = Qb cls_in_c is the class-weighted shadow of the row.  The
// outside pass walks D = L-1 .. 1 the same way with Ob, Om1, Om, Om2 and
// its own scale om[D]; bpp[i][i+D] = exp(min(log Qb + log Ob - log Z, 0)).
//
// What bounds it on the H100: latency.  A sequence is a chain of 2(L-1)
// dependent rows; a row needs the scale of every row before it (p), a block
// reduction (m) and, on the exterior chains, a chain of L dependent
// log-sum-exps.  The work is small: a batch of 200 sequences of 130 nt is
// some 3 G operations and under 0.15 GB of LUTs, 0.05 ms at the card's
// peaks.  Before this kernel the bound was the host: the plain version's
// launches.  What the design does about it: the whole fold of a batch is one
// launch, one block of 256 threads a sequence (200 blocks run at once, two
// on an SM), so each SM runs its sequences' row chains side by side.  Inside
// a block, threads take the lanes i of a row and sync between rows; the
// joint rescale is a block max.  The interior-loop double sum walks the
// nonzero (a, b, class, exp(penalty)) offsets of _class_kernels (about 500
// at max_interior 30), which the wrapper builds once a parameter set; each
// row puts the row scales and ring slots of its offsets in shared memory.
// The rows that sum reads (the last max_interior + 2 class-weighted Qb rows,
// the last 7 Qb rows, the last 2 Qm2 rows; outside the same of Ob, Om1)
// are kept in shared memory as ring buffers, lanes consecutive, with a zero
// pad on the left for the outside pass's reads at i - a.  Past about n =
// 370 (four classes) they no longer fit in one block's 227 KB, and the
// same layout lives in device memory: the SMEM template parameter, chosen
// by the launcher from n, picks one or the other; no length raises.  The
// n x n tables (Qm1, Qm, log Qb, Om2, Om, in span layout [d][i]) live in
// device memory, read coalesced over i.  The exterior chain (log Z) and
// the outside-exterior chain run on warps 0 and 1 at once, one warp taking
// each position's log-sum-exp over t.
//
// The same bits as the plain version on the card.  The benchmark's checks
// fold their references with the plain version, and a BPP one unit off in
// its last place moves the checked Grams past their limits; so the kernel
// rounds as the plain version's torch ops round on CUDA: each product and
// sum rounded on its own (no contraction into FMA), in the plain version's
// association; expf, logf and log1pf of the CUDA math library; and every
// sum in the order of the op that computes it there:
//   - the interior loops' matmul over t (cuBLAS's f32 GEMM): one FMA chain
//     in ascending t for each a, then the skew sum over a;
//   - a sum over dim 1 of a (B, m, X) tensor (the split sums, the skew
//     sums): torch's reduction (ATen/native/cuda/Reduce.cuh) lets S warps
//     take t = y + jS, four partial sums by j mod 4 added as
//     ((p0 + p1) + p2) + p3, the warps' sums in a tree; S follows from m, X
//     and B as torch's setReduceConfig derives it (torch_split);
//   - logsumexp's sum over a contiguous row: the lanes of one warp take
//     the row (four values at a time from m = 128, after a head that
//     aligns the row to 16 bytes, which depends on the row's index b), then
//     a __shfl_down tree.
// So a sequence's values depend on its batch (its width n, the batch size
// B, its index b) exactly as the plain version's do, and a fold batch gives
// the plain version's bits, checked on the card at the fold's shapes
// (tests/test_torch_fold_dp.py).  Past n of about a thousand torch splits a
// sum across blocks as well, which the kernel does not copy: there it
// agrees with the plain version within f32 rounding.
//
// The variants come from the arguments: the class count (2 in the fast
// tier, 4 in the full model), the explicit small-loop terms (none in the
// fast tier, six in the full model) with their row offsets and shifts,
// and the offset table.  w_extra, pt_override, the averaged alifold LUTs
// and CONTRAfold parameters change only the LUTs this kernel reads.  Lanes
// past a sequence's length are zero, as the plain version leaves them.
// Full f32, IEEE division, no fast-math, no flush to zero.
//
// C interface: fold_dp_f32 returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr float TINY = 1e-38f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EXPL = 8;
constexpr int MAX_CLS = 4;
constexpr int B_SLOTS = 8;  // raw Qb / Ob rows: the explicit terms reach 6 rows away
constexpr int M_SLOTS = 3;  // Qm2 rows (two back) / Om1 rows (one ahead)
constexpr int N_TABLES = 5;  // Qm1, Qm, log Qb, Om2, Om
constexpr size_t MAX_SMEM = 232448;  // 227 KB, one block's opt-in limit on sm_90
constexpr size_t STATIC_SMEM = 1024;

struct Args {
  // LUTs in span layout (B, n, n): [b][d][i] = lut[b][i][i+d]
  const float* hairpin;  // log
  const float* ext;      // log
  const float* wpair;
  const float* stack;
  const float* ml_close;
  const float* ml_stem;
  const float* expl[MAX_EXPL];
  const float* cls_out[MAX_CLS];
  const float* cls_in[MAX_CLS];
  int expl_ds[MAX_EXPL], expl_sh[MAX_EXPL];
  int n_expl, ncls, cdim, n_off;
  // the nonzero interior offsets by class, then a, then t = a + b: weight
  // K[t][a], t, a, class; seg[c * cdim + a]: the first of (c, a), with
  // seg[ncls * cdim] = n_off
  const float* off_w;
  const int *off_t, *off_a, *off_c, *seg;
  const float* cpow;  // (n,) exp(ml_unpaired t)
  float c_lin, c_ext;
  const int* lengths;  // (B,)
  int n;
  float* tables;  // (B, N_TABLES, n, n)
  float* vec;     // (B, Layout::total) when the work vectors live in device memory
  float* bpp;     // (B, n, n) [i][j]
  float* logz;    // (B,)
};

// The work vectors of one block, offsets in floats.
struct Layout {
  int padl, rs, nf;
  size_t ringx, ringb, ringm, rings_end, mu, om, qlv, oql, fa, fb, fc, fd, fk, addr, nseg, total;
};

__host__ __device__ inline Layout layout(int n, int ncls, int cdim, int n_off) {
  Layout l;
  l.padl = cdim;  // the outside reads lane i - a, a <= cdim - 2
  l.rs = l.padl + n;
  l.nf = n + cdim;
  l.ringx = 0;
  l.ringb = l.ringx + (size_t)ncls * cdim * l.rs;
  l.ringm = l.ringb + (size_t)B_SLOTS * l.rs;
  l.rings_end = l.ringm + (size_t)M_SLOTS * l.rs;
  l.mu = l.rings_end;
  l.om = l.mu + n;
  l.qlv = l.om + n;
  l.oql = l.qlv + n + 1;
  l.fa = l.oql + n;
  l.fb = l.fa + l.nf;
  l.fc = l.fb + l.nf;
  l.fd = l.fc + l.nf;
  l.fk = l.fd + l.nf;
  l.addr = l.fk + n_off;
  l.nseg = l.addr + n_off;
  l.total = l.nseg + (size_t)ncls * cdim;
  return l;
}

// f32 arithmetic rounded at each step, as the plain engine's torch ops
// round it: no product contracts into an FMA
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__host__ __device__ inline int last_pow2(long long x) {
  int p = 1;
  while (2LL * p <= x) p *= 2;
  return p;
}

// The warps a CUDA sum over dim 1 of a (B, m, X) f32 tensor splits its m
// terms across (torch's setReduceConfig, ATen/native/cuda/Reduce.cuh), for
// outputs in vectors of vec: one, or the block's height where each warp
// still sums 16 terms or more.  outputs = B X.
__host__ __device__ inline int torch_split(long long outputs, int m, int vec) {
  const int mt = 512 / vec;
  const long long d0 = outputs / vec;
  const int p0 = d0 < mt ? last_pow2(d0) : mt;
  const int p1 = m < mt ? last_pow2(m) : mt;
  int bw = p0 < 32 ? p0 : 32;
  const int bh = p1 < mt / bw ? p1 : mt / bw;
  const int thr = bh * 16 < 256 ? bh * 16 : 256;
  return m >= thr ? bh : 1;
}

// the largest of 4, 2, 1 that divides each of a, b, c
__host__ __device__ inline int vec_of(long long a, long long b, long long c) {
  int v = 4;
  while (a % v || b % v || c % v) v /= 2;
  return v;
}

// sum_t x(t), t in [lo, hi] (x is 0 elsewhere in [0, m)), in the order of
// a CUDA sum over dim 1 of a (B, m, X) tensor split across S warps: warp y
// takes t = y + j S and keeps four partial sums by j mod 4, added as
// ((p0 + p1) + p2) + p3; the warps' sums meet in a tree, y + S/2 into y
// first
template <class F>
__device__ __forceinline__ float torch_sum(int S, int lo, int hi, F x) {
  float part[16];
#pragma unroll
  for (int y = 0; y < 16; ++y) {
    part[y] = 0.f;
    if (y < S) {
      float p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p[k] = 0.f;
        const int t0 = y + k * S, step = 4 * S;
        int t = t0;
        if (lo > t0) t += (lo - t0 + step - 1) / step * step;
        for (; t <= hi; t += step) p[k] = add(p[k], x(t));
      }
      part[y] = add(add(add(p[0], p[1]), p[2]), p[3]);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    if (off < S) {
#pragma unroll
      for (int y = 0; y < 8; ++y)
        if (y < off) part[y] = add(part[y], part[y + off]);
    }
  }
  return part[0];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The maximum of v over the block, returned to every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

// torch.logaddexp on CUDA
__device__ __forceinline__ float logaddexp(float x, float y) {
  if (isinf(x) && x == y) return x;
  const float m = fmaxf(x, y);
  return add(m, log1pf(expf(-fabsf(sub(x, y)))));
}

// torch.logsumexp over dim 1 of a row-major (B, m) f32 tensor on CUDA, its
// row b, by one warp, every lane getting the result: the row's max, then
// the sum of exp(x - max) in the order of torch's contiguous reduction (the
// lanes of one warp take the row, four consecutive values at a time where
// m >= 128 after a head that aligns them to 16 bytes, a tree by
// __shfl_down last), log, plus the max.  x(t) for t in [lo, hi]; the
// others lie far enough below the max that their exp is 0, or the row is
// all NEG and so is the result.
template <class F>
__device__ float warp_logsumexp(int b, int B, int m, int lo, int hi, int lane, F x) {
  float mx = -INFINITY;
  for (int t = lo + lane; t <= hi; t += 32) mx = fmaxf(mx, x(t));
  mx = warp_max(mx);
  if (!(mx > -1e29f)) return NEG;
  auto e = [&](int t) { return t >= lo && t <= hi ? expf(sub(x(t), mx)) : 0.f; };
  const bool vec = m >= 128;
  const long long d0 = vec ? m / 4 : m;
  const int p0 = d0 < 512 ? last_pow2(d0) : 512;
  const int p1 = B < 512 ? last_pow2(B) : 512;
  int bw = p0 < 32 ? p0 : 32;
  const int bh = p1 < 512 / bw ? p1 : 512 / bw;
  bw = p0 < 512 / bh ? p0 : 512 / bh;
  float part[16];  // this lane's threads lane, lane + 32, ...
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    part[r] = 0.f;
    const int v = lane + 32 * r;
    if (v >= bw) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec) {
      int shift = (int)(((long long)b * m) % 4), end = m, base = 0;
      if (shift > 0) {
        base = -shift;
        end += shift;
        if (v >= shift && v < 4) acc[0] = add(acc[0], e(v - shift));
        end -= 4;
        base += 4;
      }
      for (int idx = v; idx * 4 + 3 < end; idx += bw) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = add(acc[k], e(base + idx * 4 + k));
      }
      const int i2 = end - end % 4 + v;
      if (i2 < end) acc[0] = add(acc[0], e(base + i2));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (int t = v + k * bw; t < m; t += 4 * bw) acc[k] = add(acc[k], e(t));
    }
    part[r] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  // threads v + off into v, off = bw / 2 .. 32, then the warp's tree
  for (int off = bw / 2; off >= 32; off >>= 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (32 * r < off) part[r] = add(part[r], part[r + off / 32]);
  }
  float s = part[0];
  for (int off = (bw < 32 ? bw : 32) / 2; off > 0; off >>= 1) s = add(s, __shfl_down_sync(FULL, s, off));
  s = __shfl_sync(FULL, s, 0);
  return add(logf(s), mx);
}

// sum_a w(a) over the interior offsets of one loop class, for one lane:
// the plain engine's matmul (sum over t of K[t][a] times the slab, one FMA
// chain in ascending t, as cuBLAS's f32 GEMM runs it) and its skew sum over
// a (a CUDA sum over dim 1 of the (B, cdim, X) skew view)
__device__ __forceinline__ float class_sum(const float* __restrict__ off_w,
                                           const float* __restrict__ fk,
                                           const int* __restrict__ addr,
                                           const int* __restrict__ seg,
                                           const int* __restrict__ nseg,
                                           const float* __restrict__ ring, int c, int cdim,
                                           int S, int i) {
  return torch_sum(S, 1, cdim - 1, [&](int a) {
    const int s = c * cdim + a, k0 = seg[s], k1 = k0 + nseg[s];
    float w = 0.f;
    for (int k = k0; k < k1; ++k) w = __fmaf_rn(off_w[k], mul(ring[addr[k] + i], fk[k]), w);
    return w;
  });
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS, 2) fold_dp(const Args a) {
  extern __shared__ float dyn[];
  __shared__ float red[WARPS];
  const int b = blockIdx.x, B = gridDim.x, tid = threadIdx.x;
  const int n = a.n, cdim = a.cdim, ncls = a.ncls, n_expl = a.n_expl;
  const Layout lay = layout(n, ncls, cdim, a.n_off);
  float* v = SMEM ? dyn : a.vec + (size_t)b * lay.total;
  const int L = min(max(a.lengths[b], 0), n);
  const size_t nn = (size_t)n * n, ob = (size_t)b * nn;
  const int rs = lay.rs, padl = lay.padl;
  // the warps the plain engine's sums split across: over t of (B, n, n)
  // (Qm2, Qm, the Om row); over a of the (B, cdim, n + cdim - 1) skew view
  // (the loop classes); over t of the (B, n, 2n - 1) skew view (Om1)
  const int s_rows = torch_split((long long)B * n, n, vec_of(n, n, n));
  const int s_cls = torch_split((long long)B * (n + cdim - 1), cdim,
                                vec_of(n + cdim - 1, (long long)cdim * (n + cdim), 1));
  const int s_skew = torch_split((long long)B * (2 * n - 1), n, vec_of(2 * n - 1, 2LL * n * n, 1));

  float* ringx = v + lay.ringx;
  float* ringb = v + lay.ringb + padl;  // lane 0 of slot 0
  float* ringm = v + lay.ringm + padl;
  float* mu = v + lay.mu;
  float* om = v + lay.om;
  float* qlv = v + lay.qlv;
  float* oql = v + lay.oql;
  float* fa = v + lay.fa;
  float* fb = v + lay.fb;
  float* fc = v + lay.fc;
  float* fd = v + lay.fd;
  float* fk = v + lay.fk;
  int* addr = reinterpret_cast<int*>(v + lay.addr);
  int* nseg = reinterpret_cast<int*>(v + lay.nseg);

  float* Qm1 = a.tables + (size_t)b * N_TABLES * nn;
  float* Qm = Qm1 + nn;
  float* lqb = Qm + nn;
  float* Om2 = lqb + nn;
  float* Om = Om2 + nn;
  float* out = a.bpp + ob;
  const float* __restrict__ hairpin = a.hairpin + ob;
  const float* __restrict__ ext = a.ext + ob;
  const float* __restrict__ wpair = a.wpair + ob;
  const float* __restrict__ stack = a.stack + ob;
  const float* __restrict__ ml_close = a.ml_close + ob;
  const float* __restrict__ ml_stem = a.ml_stem + ob;
  const float* __restrict__ cpow = a.cpow;
  const float c_lin = a.c_lin, c_ext = a.c_ext;

  for (size_t x = tid; x < nn; x += THREADS) out[x] = 0.f;
  for (size_t x = tid; x < lay.rings_end; x += THREADS) v[x] = 0.f;
  for (int x = tid; x < n; x += THREADS) mu[x] = om[x] = oql[x] = NEG;
  for (int x = tid; x <= n; x += THREADS) qlv[x] = NEG;
  __syncthreads();

  // ---------------------------------------------------------------- inside
  {
    float* fs = fa;    // exp(mu[d-t] - p)
    float* fw = fb;    // exp(mu[t-1] + mu[d-t] - p)
    float* funp = fc;  // c^t fs[t], 1 at t = 0
    for (int d = 1; d < L; ++d) {
      const int nv = L - d;
      float pm = -INFINITY;
      for (int t = 1 + tid; t <= d; t += THREADS) {
        const float ms = mu[d - t];
        pm = fmaxf(pm, fmaxf(add(mu[t - 1], ms), ms));
      }
      for (int i = tid; i < nv; i += THREADS) pm = fmaxf(pm, hairpin[(size_t)d * n + i]);
      float p = block_max(pm, red);
      if (p < -1e29f) p = 0.f;

      for (int t = tid; t <= d; t += THREADS) {
        const float f = expf(sub(mu[d - t], p));
        fs[t] = f;
        fw[t] = t >= 1 ? expf(sub(add(mu[t - 1], mu[d - t]), p)) : 0.f;
        funp[t] = t == 0 ? 1.f : mul(cpow[t], f);
      }
      for (int k = tid; k < a.n_off; k += THREADS) {
        const int t = a.off_t[k];
        if (t < d) {
          fk[k] = expf(sub(mu[d - t], p));
          addr[k] = (a.off_c[k] * cdim + (d - t) % cdim) * rs + padl + a.off_a[k];
        }
      }
      for (int s = tid; s < ncls * cdim; s += THREADS) {  // the offsets of (c, a) with t < d
        int k = a.seg[s];
        const int k1 = a.seg[s + 1];
        while (k < k1 && a.off_t[k] < d) ++k;
        nseg[s] = k - a.seg[s];
      }
      __syncthreads();

      const float f1 = fs[1];
      float lmax = 0.f;
      for (int i = tid; i < nv; i += THREADS) {
        const size_t row = (size_t)d * n + i;
        float acc = expf(sub(hairpin[row], p));
        if (d > 2) acc = add(acc, mul(stack[row], mul(ringb[((d - 2) & 7) * rs + i + 1], fs[2])));
#pragma unroll
        for (int e = 0; e < MAX_EXPL; ++e) {
          if (e < n_expl) {
            const int ds = a.expl_ds[e];
            if (d > ds)
              acc = add(acc, mul(a.expl[e][ob + row],
                                 mul(ringb[((d - ds) & 7) * rs + i + a.expl_sh[e]], fs[ds])));
          }
        }
#pragma unroll
        for (int c = 0; c < MAX_CLS; ++c) {
          if (c < ncls)
            acc = add(acc, mul(a.cls_out[c][ob + row],
                               class_sum(a.off_w, fk, addr, a.seg, nseg, ringx, c, cdim, s_cls, i)));
        }
        if (d > 2) acc = add(acc, mul(ml_close[row], mul(ringm[((d - 2) % 3) * rs + i + 1], fs[2])));
        const float qb = mul(wpair[row], acc);
        const float prev = d >= 2 ? Qm1[row - n] : 0.f;
        const float qm1 = add(mul(mul(c_lin, prev), f1), mul(ml_stem[row], qb));
        // u(t) = Qm1(span d - t, start i + t), t >= 1; the fresh row at t = 0
        auto u = [&](int t) { return Qm1[(size_t)(d - t) * n + i + t]; };
        const float q2 = torch_sum(s_rows, 2, d - 1, [&](int t) {
          return mul(mul(Qm[(size_t)(t - 1) * n + i], u(t)), fw[t]);
        });
        const float qm = add(q2, torch_sum(s_rows, 0, d - 1, [&](int t) {
          return t == 0 ? qm1 : mul(u(t), funp[t]);
        }));

        ringb[(d & 7) * rs + i] = qb;
        ringm[(d % 3) * rs + i] = q2;
        Qm1[row] = qm1;
        Qm[row] = qm;
        lmax = fmaxf(lmax, fmaxf(fmaxf(qb, qm1), fmaxf(qm, q2)));
      }
      const float m = block_max(lmax, red);
      const float scale = m > 0.f ? m : 1.f;
      const float inv = 1.f / scale;
      const float mud = m > 0.f ? add(p, logf(scale)) : NEG;
      const int sx = (d % cdim) * rs + padl;
      for (int i = tid; i < nv; i += THREADS) {
        const size_t row = (size_t)d * n + i;
        const float qb = mul(ringb[(d & 7) * rs + i], inv);
        ringb[(d & 7) * rs + i] = qb;
        ringm[(d % 3) * rs + i] = mul(ringm[(d % 3) * rs + i], inv);
        Qm1[row] = mul(Qm1[row], inv);
        Qm[row] = mul(Qm[row], inv);
#pragma unroll
        for (int c = 0; c < MAX_CLS; ++c)
          if (c < ncls) ringx[c * cdim * rs + sx + i] = mul(qb, a.cls_in[c][ob + row]);
        lqb[row] = qb > 0.f ? add(logf(fmaxf(qb, TINY)), mud) : NEG;
      }
      if (tid == 0) mu[d] = mud;
      __syncthreads();
    }
  }

  // log QbE(span t, start s): the exterior-weighted log Qb
  auto lqbe = [&](int t, int s) {
    const size_t r = (size_t)t * n + s;
    return fmaxf(add(lqb[r], ext[r]), NEG);
  };

  // ------------------------------------- exterior and outside-exterior chains
  {
    const int warp = tid >> 5, lane = tid & 31;
    if (warp == 0) {
      // qlv[j + 1] = logaddexp(qlv[j] + c_ext, lse_t (QbE(t, j - t) + qlv[j - t]))
      if (lane == 0) qlv[0] = 0.f;
      __syncwarp();
      for (int j = 0; j < L; ++j) {
        const float paired = warp_logsumexp(b, B, n, 1, j, lane, [&](int t) {
          return add(lqbe(t, j - t), qlv[j - t]);
        });
        const float val = logaddexp(add(qlv[j], c_ext), paired);
        __syncwarp();
        if (lane == 0) qlv[j + 1] = val;
        __syncwarp();
      }
    } else if (warp == 1) {
      // oql[j] = logaddexp(oql[j + 1] + c_ext, lse_t (QbE(t, j + 1) + oql[j + 1 + t]))
      if (lane == 0 && L >= 1) oql[L - 1] = 0.f;
      __syncwarp();
      for (int j = L - 2; j >= 0; --j) {
        const float paired = warp_logsumexp(b, B, n, 1, L - 2 - j, lane, [&](int t) {
          return add(lqbe(t, j + 1), oql[j + 1 + t]);
        });
        const float val = logaddexp(add(oql[j + 1], c_ext), paired);
        __syncwarp();
        if (lane == 0) oql[j] = val;
        __syncwarp();
      }
    } else {
      // the outside pass's rings start at zero: it reads past its rows' lanes
      for (size_t x = tid - 64; x < lay.rings_end; x += THREADS - 64) v[x] = 0.f;
    }
    __syncthreads();
  }
  const float logZ = qlv[L];
  if (tid == 0) a.logz[b] = logZ;

  // --------------------------------------------------------------- outside
  {
    float* e = fa;   // exp(om[D+k] - p)
    float* fo = fb;  // exp(mu[r] + om[D+1+r] - p)
    float* gb = fc;  // exp(mu[t-1] + om[D+t] - p)
    float* gc = fd;  // c^t exp(om[D+t] - p)
    for (int D = L - 1; D >= 1; --D) {
      const int nv = L - D;
      float pm = -INFINITY;
      for (int t = tid; D + t <= L - 1; t += THREADS) {
        if (t >= 1) pm = fmaxf(pm, add(mu[t], om[D + t]));
        if (D + 1 + t <= L - 1) {
          const float o = om[D + 1 + t];
          pm = fmaxf(pm, o);
          if (t >= 1) pm = fmaxf(pm, add(mu[t - 1], o));
        }
      }
      for (int i = tid; i < nv; i += THREADS)
        pm = fmaxf(pm, add(add(qlv[i], oql[i + D]), ext[(size_t)D * n + i]));
      float p = block_max(pm, red);
      if (p < -1e29f) p = 0.f;

      for (int k = tid; k < lay.nf; k += THREADS) {
        const bool in = D + k <= L - 1;
        const float ek = in ? expf(sub(om[D + k], p)) : 0.f;
        e[k] = ek;
        fo[k] = k >= 1 && D + 1 + k <= L - 1 ? expf(sub(add(mu[k], om[D + 1 + k]), p)) : 0.f;
        gb[k] = k >= 2 && in ? expf(sub(add(mu[k - 1], om[D + k]), p)) : 0.f;
        gc[k] = k >= 1 && in ? mul(cpow[k], ek) : 0.f;
      }
      for (int k = tid; k < a.n_off; k += THREADS) {
        const int t = a.off_t[k];
        if (D + t <= L - 1) {
          fk[k] = expf(sub(om[D + t], p));
          addr[k] = (a.off_c[k] * cdim + (D + t) % cdim) * rs + padl - a.off_a[k];
        }
      }
      for (int s = tid; s < ncls * cdim; s += THREADS) {  // the offsets of (c, a) with D + t < L
        int k = a.seg[s];
        const int k1 = a.seg[s + 1];
        while (k < k1 && D + a.off_t[k] <= L - 1) ++k;
        nseg[s] = k - a.seg[s];
      }
      __syncthreads();

      float lmax = 0.f;
      for (int i = tid; i < nv; i += THREADS) {
        const size_t row = (size_t)D * n + i;
        const float omr = torch_sum(s_rows, 1, L - D - 2 - i, [&](int r) {
          return mul(mul(Qm1[(size_t)r * n + i + D + 1], Om2[(size_t)(D + 1 + r) * n + i]), fo[r]);
        });
        float close = 0.f, stk = 0.f;
        if (i >= 1 && D + 2 <= L - 1) {
          const size_t r2 = (size_t)(D + 2) * n + i - 1;
          const float o = mul(ringb[((D + 2) & 7) * rs + i - 1], wpair[r2]);
          close = mul(mul(o, ml_close[r2]), e[2]);
          stk = mul(mul(o, stack[r2]), e[2]);
        }
        const float om2 = add(close, omr);
        const float inc = mul(mul(c_lin, ringm[((D + 1) & 1) * rs + i]), e[1]);
        const float tb = torch_sum(s_skew, 2, i, [&](int t) {
          return mul(mul(Qm[(size_t)(t - 1) * n + i - t], Om2[(size_t)(D + t) * n + i - t]), gb[t]);
        });
        const float tc = torch_sum(s_skew, 1, i, [&](int t) {
          return mul(Om[(size_t)(D + t) * n + i - t], gc[t]);
        });
        const float om1 = add(add(inc, tb), add(omr, tc));

        float acc = add(expf(fminf(sub(add(add(qlv[i], oql[i + D]), ext[row]), p), 60.f)), stk);
#pragma unroll
        for (int x = 0; x < MAX_EXPL; ++x) {
          if (x < n_expl) {
            const int ds = a.expl_ds[x], sh = a.expl_sh[x];
            if (i >= sh && D + ds <= L - 1) {
              const size_t r = (size_t)(D + ds) * n + i - sh;
              acc = add(acc, mul(mul(mul(ringb[((D + ds) & 7) * rs + i - sh], wpair[r]),
                                     a.expl[x][ob + r]), e[ds]));
            }
          }
        }
#pragma unroll
        for (int c = 0; c < MAX_CLS; ++c) {
          if (c < ncls)
            acc = add(acc, mul(a.cls_in[c][ob + row],
                               class_sum(a.off_w, fk, addr, a.seg, nseg, ringx, c, cdim, s_cls, i)));
        }
        const float obv = add(acc, mul(ml_stem[row], om1));

        ringb[(D & 7) * rs + i] = obv;
        ringm[(D & 1) * rs + i] = om1;
        Om[row] = omr;
        Om2[row] = om2;
        lmax = fmaxf(lmax, fmaxf(fmaxf(obv, om1), fmaxf(omr, om2)));
      }
      const float m = block_max(lmax, red);
      const float scale = m > 0.f ? m : 1.f;
      const float inv = 1.f / scale;
      const float omd = m > 0.f ? add(p, logf(scale)) : NEG;
      const int sx = (D % cdim) * rs + padl;
      for (int i = tid; i < nv; i += THREADS) {
        const size_t row = (size_t)D * n + i;
        const float obv = mul(ringb[(D & 7) * rs + i], inv);
        ringb[(D & 7) * rs + i] = obv;
        ringm[(D & 1) * rs + i] = mul(ringm[(D & 1) * rs + i], inv);
        Om[row] = mul(Om[row], inv);
        Om2[row] = mul(Om2[row], inv);
        const float w = mul(obv, wpair[row]);
#pragma unroll
        for (int c = 0; c < MAX_CLS; ++c)
          if (c < ncls) ringx[c * cdim * rs + sx + i] = mul(w, a.cls_out[c][ob + row]);
        const float lob = obv > 0.f ? add(logf(fmaxf(obv, TINY)), omd) : NEG;
        out[(size_t)i * n + i + D] = expf(fminf(sub(add(lqb[row], lob), logZ), 0.f));
      }
      if (tid == 0) om[D] = omd;
      __syncthreads();
    }
  }
}

bool smem_route(const Layout& l) { return l.total * sizeof(float) + STATIC_SMEM <= MAX_SMEM; }

}  // namespace

extern "C" {

// floats of device scratch a launch needs: the n x n tables, and the work
// vectors where they do not fit in shared memory
long long fold_dp_scratch_floats(int batch, int n, int ncls, int cdim, int n_off) {
  const Layout l = layout(n, ncls, cdim, n_off);
  const long long tables = (long long)N_TABLES * n * n;
  return (long long)batch * (tables + (smem_route(l) ? 0 : (long long)l.total));
}

// 1 when the work vectors sit in shared memory, 0 in device memory; *bytes:
// their size
int fold_dp_route(int n, int ncls, int cdim, int n_off, long long* bytes) {
  const Layout l = layout(n, ncls, cdim, n_off);
  if (bytes != nullptr) *bytes = (long long)(l.total * sizeof(float));
  return smem_route(l) ? 1 : 0;
}

// tabs: host array of the LUTs' device pointers, in the order hairpin, ext,
// wpair, stack, ml_close, ml_stem, the n_expl explicit terms, the ncls
// cls_out, the ncls cls_in; expl_ds, expl_sh: host arrays (n_expl);
// off_meta: device int32 [t (n_off), a (n_off), class (n_off), seg
// (ncls cdim + 1)]
int fold_dp_f32(const float* const* tabs, const int* expl_ds, const int* expl_sh, int n_expl,
                int ncls, int cdim, int n_off, const float* off_w, const int* off_meta,
                const float* cpow, float c_lin, float c_ext, const int* lengths, int batch, int n,
                float* scratch, float* bpp, float* logz, void* stream) {
  if (n_expl < 0 || n_expl > MAX_EXPL || ncls < 1 || ncls > MAX_CLS || n < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.hairpin = tabs[0];
  a.ext = tabs[1];
  a.wpair = tabs[2];
  a.stack = tabs[3];
  a.ml_close = tabs[4];
  a.ml_stem = tabs[5];
  for (int e = 0; e < n_expl; ++e) {
    a.expl[e] = tabs[6 + e];
    a.expl_ds[e] = expl_ds[e];
    a.expl_sh[e] = expl_sh[e];
  }
  for (int c = 0; c < ncls; ++c) {
    a.cls_out[c] = tabs[6 + n_expl + c];
    a.cls_in[c] = tabs[6 + n_expl + ncls + c];
  }
  a.n_expl = n_expl;
  a.ncls = ncls;
  a.cdim = cdim;
  a.n_off = n_off;
  a.off_w = off_w;
  a.off_t = off_meta;
  a.off_a = off_meta + n_off;
  a.off_c = off_meta + 2 * n_off;
  a.seg = off_meta + 3 * n_off;
  a.cpow = cpow;
  a.c_lin = c_lin;
  a.c_ext = c_ext;
  a.lengths = lengths;
  a.n = n;
  a.tables = scratch;
  a.bpp = bpp;
  a.logz = logz;
  const Layout l = layout(n, ncls, cdim, n_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_route(l)) {
    const size_t bytes = l.total * sizeof(float);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fold_dp<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    a.vec = nullptr;
    fold_dp<true><<<batch, THREADS, bytes, s>>>(a);
  } else {
    a.vec = scratch + (size_t)batch * N_TABLES * n * n;
    fold_dp<false><<<batch, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
